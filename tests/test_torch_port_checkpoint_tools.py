"""The checkpoint importers against the JAX package, on the CPU.

``tools/import_torch_checkpoint.py`` of the port: the reference repo's
``.pth`` state_dicts of its MobileViT-S ``VideoClassifier`` and of TinyViT.
No reference checkout is here, so the test writes the reference-named
state_dict itself, from a JAX model's seeded variables (perturbed off their
init, BatchNorm statistics made non-trivial), by the inverse of the JAX
tool's layout rules (``tools/import_torch_checkpoint.py:11-40``), written
out below on its own. JAX's converter must give the variables back
exactly; the port's importer, applied to the same dict, must give the
JAX model's logits (TinyViT: its stage-3 features) to 1e-4.

``tools/orbax_to_npz.py``: a JAX Orbax checkpoint, saved with the JAX
package's ``save_checkpoint``, becomes the ``.npz`` the port reads; the port
classifier built from it gives JAX's logits to 1e-4, and the sidecar's
metadata comes through.
"""
import argparse
import os
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
from ssl_vit_video_analytics_tpu_torch.tools import import_torch_checkpoint as imp
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as teng
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import read_checkpoint, restore_checkpoint
from ssl_vit_video_analytics_tpu_torch.utils.convert import flatten_variables, unflatten_variables

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from tools import import_torch_checkpoint as jimp  # noqa: E402
from tools.orbax_to_npz import orbax_to_npz  # noqa: E402

torch.set_num_threads(2)  # six test workers share the host

T, S, C, D = 2, 32, 5, 32
DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)


def _perturb(v, seed):
    rng = np.random.default_rng(seed)
    flat = flatten_variables(jax.tree.map(np.asarray, v))
    for key, a in flat.items():
        if key.endswith("/mean"):
            a = 0.3 * rng.standard_normal(a.shape)
        elif key.endswith("/var"):
            a = rng.uniform(0.5, 2.0, a.shape)
        else:
            a = a + 0.1 * rng.standard_normal(a.shape)
        flat[key] = a.astype(np.float32)
    return unflatten_variables(flat)


# --- the inverse of the JAX tool's name map and layout rules

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_MVIT_CONV = {"ConvBNAct_0": "local1", "ConvBNAct_1": "local2", "ConvBNAct_2": "proj",
              "ConvBNAct_3": "fuse"}
_IR_CONV = {"ConvBNAct_0": "pw1", "ConvBNAct_1": "dw", "ConvBNAct_2": "pw2"}
_COMMON = {"Conv_0": "conv", "BatchNorm_0": "bn", "LayerNorm_0": "norm1",
           "LayerNorm_1": "norm2"}


def _mobilevit_name(path: list[str]) -> list[str]:
    """Flax scopes of the classifier -> the reference module path."""
    if path[0] == "head":
        return ["classifier"]
    out = ["backbone"]
    top, rest = path[1], path[2:]
    if m := re.fullmatch(r"s(\d)_(\d)", top):
        out += [f"s{m[1]}", m[2]]
        inner = _IR_CONV
    elif m := re.fullmatch(r"mvit(\d)_ir", top):
        out += [f"mvit{m[1]}", "0"]
        inner = _IR_CONV
    elif m := re.fullmatch(r"mvit(\d)", top):
        out += [f"mvit{m[1]}", "1"]
        inner = _MVIT_CONV
    else:
        out += [top] + (["0"] if top == "head" else [])
        inner = {}
    mlp = {"Dense_0": "0", "Dense_1": "3"}
    for name in rest:
        if m := re.fullmatch(r"tblock(\d+)", name):
            out += ["transformer", m[1]]
        elif name == "MultiHeadAttention_0":
            out.append("attn")
        elif name == "Mlp_0":
            out.append("mlp")
        elif name in mlp and out[-1] == "mlp":
            out.append(mlp[name])
        elif name == "proj" and out[-1] == "attn":
            out.append("out_proj")
        else:
            out.append(inner.get(name) or _COMMON.get(name, name))
    return out


_TV_MBCONV = {"ConvBNAct_0": "conv.0", "ConvBNAct_1": "conv.2", "ConvBNAct_2": "conv.5"}


def _tinyvit_name(path: list[str]) -> list[str]:
    """Flax scopes of a TinyViT -> the reference module path."""
    if path[0] == "patch_embed":
        return ["patch_embed", "patch_embed", {"ConvBNAct_0": "0", "ConvBNAct_1": "2"}[path[1]],
                *[{"Conv_0": "c"}.get(n, _COMMON.get(n, n)) for n in path[2:]]]
    i = int(path[0][len("stage"):])
    block, rest = path[1], path[2:]
    if block == "down":
        out = ["stages", str(i), "0"]
    else:
        j = int(re.sub(r"\D", "", block))
        out = ["stages", str(i), str(j + (1 if i else 0))]
    for name in rest:
        if name in _TV_MBCONV:
            out.append(_TV_MBCONV[name])
        elif name == "SELayer_0":
            out += ["conv", "4", "fc"]
        elif name in ("Dense_0", "Dense_1") and out[-1] == "fc":
            out.append({"Dense_0": "0", "Dense_1": "2"}[name])
        elif name in ("Dense_0", "Dense_1"):
            out.append({"Dense_0": "fc1", "Dense_1": "fc2"}[name])
        elif name == "MultiHeadAttention_0":
            out.append("attn")
        elif name == "Mlp_0":
            out.append("mlp")
        elif name == "Conv_0":
            out.append("c")
        else:
            out.append(_COMMON.get(name, name))
    return out


def reference_state_dict(variables, name_of) -> dict[str, np.ndarray]:
    """A flax tree -> reference-named numpy tensors: conv kernels
    ``[kh, kw, I/g, O]`` -> ``[O, I/g, kh, kw]``, dense kernels transposed,
    the fused qkv of ``nn.MultiheadAttention`` as ``in_proj_*``."""
    sd = {}
    for key, a in flatten_variables(variables).items():
        collection, *path, leaf = key.split("/")
        mod = name_of(path)
        if leaf == "kernel":
            a, leaf = (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T), "weight"
        else:
            leaf = _LEAF[leaf]
        if mod[-1] == "qkv" and mod[-2] == "attn" and name_of is _mobilevit_name:
            mod, leaf = mod[:-1], f"in_proj_{leaf}"
        sd[".".join(mod + [leaf])] = np.ascontiguousarray(a)
    return sd


@pytest.fixture(scope="module")
def classifier():
    model = jeng.build_model(C, D)
    v = _perturb(jeng.init_model(model, jax.random.key(0), (1, T, S, S, 3)), 1)
    return model, v


def _assert_trees_equal(got, ref):
    g, r = flatten_variables(got), flatten_variables(jax.tree.map(np.asarray, ref))
    assert set(g) == set(r)
    for k in r:
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def _port_logits(sd, clip):
    model = teng.build_model(C, D)
    model.load_state_dict(sd)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(clip)).numpy()


def test_mobilevit_import_gives_the_jax_models_logits(classifier, capsys):
    model, v = classifier
    sd = reference_state_dict(v, _mobilevit_name)
    assert {"backbone.stem.conv.weight", "backbone.s1.0.pw1.bn.running_var",
            "backbone.mvit2.1.transformer.1.attn.in_proj_weight",
            "backbone.mvit3.1.transformer.0.mlp.3.bias", "backbone.head.0.conv.weight",
            "classifier.weight"} <= set(sd)
    _assert_trees_equal(jimp.convert_classifier_state_dict(sd), v)  # the inverse is exact
    _assert_trees_equal(imp.convert_classifier_state_dict(sd), v)
    clip = np.random.default_rng(2).standard_normal((2, T, S, S, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda c: model.apply(v, c, train=False))(clip))
    np.testing.assert_allclose(_port_logits(imp.classifier_state_dict(sd), clip), ref,
                               rtol=1e-4, atol=1e-4)
    assert capsys.readouterr().out == ""  # every key consumed
    imp.convert_classifier_state_dict({**sd, "backbone.extra.weight": np.zeros(3)})
    assert "1 state_dict keys were NOT consumed" in capsys.readouterr().out


@pytest.mark.parametrize("stages", [4, 3], ids=["whole", "stage3_only"])
def test_tinyvit_import_gives_the_jax_encoders_features(stages, capsys):
    jax_enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, use_checkpoint=False,
                         drop_path_rate=0.0)
    x = np.random.default_rng(3).standard_normal((2, S, S, 3)).astype(np.float32)
    v = _perturb(jax.jit(lambda k: jax_enc.init(k, jnp.asarray(x)))(jax.random.key(4)), 5)
    if stages == 3:  # a forward_stage3-only checkpoint: stage 3 never made
        v = {c: {k: t for k, t in v[c].items() if k != "stage3"} for c in v}
    sd = {f"encoder.{k}": t for k, t in reference_state_dict(v, _tinyvit_name).items()}
    _assert_trees_equal(jimp.convert_tinyvit_state_dict(sd, prefix="encoder.",
                                                        depths=DEPTHS), v)
    capsys.readouterr()
    got = imp.tinyvit_encoder_state_dict(sd, prefix="encoder.", depths=DEPTHS)
    assert ("stopping conversion at stage 3" in capsys.readouterr().out) == (stages == 3)
    port = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                   use_checkpoint=False, num_stages=stages)
    port.load_state_dict({k[len("encoder."):]: t for k, t in got.items()})
    ref = np.asarray(jax.jit(lambda a: jax_enc.apply(v, a, train=False, stage_limit=3))(x))
    with torch.no_grad():
        out = port.eval().forward_stage3(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_import_cli_writes_a_finetune_ckpt_and_gates_full_unpickling(classifier, tmp_path,
                                                                    monkeypatch, capsys):
    model, v = classifier
    sd = {k: torch.from_numpy(a) for k, a in reference_state_dict(v, _mobilevit_name).items()}
    torch.save({"model": sd}, tmp_path / "ref.pth")
    monkeypatch.setattr(sys, "argv", ["imp", "--torch_ckpt", str(tmp_path / "ref.pth"),
                                      "--out", str(tmp_path / "out" / "best")])
    imp.main()
    assert capsys.readouterr().out.startswith(f"[INFO] wrote {tmp_path / 'out' / 'best.pt'} (")
    clip = np.random.default_rng(6).standard_normal((1, T, S, S, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda c: model.apply(v, c, train=False))(clip))
    np.testing.assert_allclose(_port_logits(read_checkpoint(str(tmp_path / "out" / "best")),
                                            clip), ref, rtol=1e-4, atol=1e-4)
    # a pickle that holds more than tensors needs --unsafe
    torch.save({"model": sd, "args": argparse.Namespace(lr=1)}, tmp_path / "full.pth")
    argv = ["imp", "--torch_ckpt", str(tmp_path / "full.pth"), "--out", str(tmp_path / "f")]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(SystemExit, match="--unsafe"):
        imp.main()
    monkeypatch.setattr(sys, "argv", argv + ["--unsafe"])
    imp.main()
    assert "falling back to full unpickling" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "f.pt")


def test_orbax_to_npz_feeds_the_port_the_jax_checkpoint(classifier, tmp_path):
    model, v = classifier
    ckpt = jax_save_checkpoint(str(tmp_path), "best",
                               {"params": v["params"], "batch_stats": v["batch_stats"],
                                "step": jnp.asarray(7)}, meta={"epoch": 3, "top1": 0.5})
    path = orbax_to_npz(ckpt, str(tmp_path / "flax" / "best"))
    assert path == str(tmp_path / "flax" / "best.npz")
    blob = restore_checkpoint(path)
    assert (blob["epoch"], blob["top1"], blob["step"]) == (3, 0.5, 7)
    clip = np.random.default_rng(7).standard_normal((2, T, S, S, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda c: model.apply(v, c, train=False))(clip))
    np.testing.assert_allclose(_port_logits(read_checkpoint(path), clip), ref,
                               rtol=1e-4, atol=1e-4)
