"""The port's serving export (``tools/export_serving.py``) on the CPU: a
tiny MobileViT-S classifier (embed 32, 5 classes, 2 frames of 32x32) with
the JAX package's weights (perturbed off their init, BatchNorm statistics
made non-trivial), baked in through ``model.finetune_ckpt``, exported with
a symbolic batch through the plain attention, saved, loaded and served.

Tolerances: the served logits against the live port model 1e-5 (the same
ops, traced), against JAX's live model 1e-4 (the port's fp32 layers against
XLA's), at batches 2 and 4 from one artifact (and 1 and 8)."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu_torch.entry import run_dynamic
from ssl_vit_video_analytics_tpu_torch.models.layers import MultiHeadAttention
from ssl_vit_video_analytics_tpu_torch.tools import export_serving
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import save_checkpoint
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    classifier_state_dict_from_flax, flatten_variables, unflatten_variables)

torch.set_num_threads(2)  # six test workers share the host

T, S, C, D = 2, 32, 5, 32


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


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX model, its variables, config, artifact path) with the JAX
    weights baked into the artifact."""
    tmp = tmp_path_factory.mktemp("export")
    model = jeng.build_model(C, D)
    v = _perturb(jeng.init_model(model, jax.random.key(0), (1, T, S, S, 3)), 1)
    save_checkpoint(str(tmp), "best", classifier_state_dict_from_flax(v))
    cfg = {"dataset": {"clip_len": T, "image_size": S, "num_classes": C},
           "model": {"embed_dim": D, "backbone": "mobilevit_s",
                     "finetune_ckpt": str(tmp / "best")}}
    lines = []
    program = export_serving.export_classifier(cfg, "cpu", log=lines.append)
    assert lines == [f"[INFO] loaded finetune ckpt: {tmp / 'best'}",
                     "[INFO] exporting with the plain attention (portable: no kernel "
                     "library needed)"]
    path = str(tmp / "clf.pt2")
    torch.export.save(program, path)
    return model, v, cfg, path


def test_export_roundtrip_matches_the_live_model_and_jax(exported):
    model, v, cfg, path = exported
    served = torch.export.load(path).module()
    live = run_dynamic.load_classifier(cfg, torch.float32, torch.device("cpu"),
                                       lambda m: None)
    clips = np.random.default_rng(2).standard_normal((8, T, S, S, 3)).astype(np.float32)
    # eval mode: a clip's logits do not depend on the rest of its batch
    ref_jax = np.asarray(jax.jit(lambda c: model.apply(v, c, train=False))(clips[:4]))
    for B in (2, 4, 1, 8):  # symbolic batch: one artifact, several batch sizes
        clip = torch.from_numpy(clips[:B])
        with torch.no_grad():
            got = served(clip).numpy()
            ref_port = live(clip).numpy()
        assert got.shape == (B, C)
        np.testing.assert_allclose(got, ref_port, rtol=1e-5, atol=1e-5)
        if B in (2, 4):
            np.testing.assert_allclose(got, ref_jax[:B], rtol=1e-4, atol=1e-4)


def test_export_runs_the_plain_attention_and_puts_the_kernel_back(exported):
    _, _, cfg, path = exported
    program = torch.export.load(path)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "aten.softmax.int" in targets  # the plain attention, traced
    assert export_serving.artifact_input(program)[0][1:] == (T, S, S, 3)
    model = run_dynamic.load_classifier(cfg, torch.float32, torch.device("cpu"),
                                        lambda m: None)
    layers = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    assert len(layers) == 6 and {m.attn_impl for m in layers} == {None}
    with pytest.raises(RuntimeError, match="inside"):
        with export_serving.plain_attention(model):
            assert {m.attn_impl for m in layers} == {"plain"}
            raise RuntimeError("inside")
    assert {m.attn_impl for m in layers} == {None}


def test_export_cli_writes_and_serves_the_artifact(exported, tmp_path, monkeypatch, capsys):
    _, _, cfg, path = exported
    cfg_path = tmp_path / "cfg.yaml"
    import yaml

    cfg_path.write_text(yaml.safe_dump(dict(cfg, model=dict(cfg["model"], finetune_ckpt=None))))
    out = tmp_path / "o" / "clf.pt2"
    monkeypatch.setattr(sys, "argv", ["export_serving", "--config", str(cfg_path), "--base", "",
                                      "--out", str(out), "--device", "cpu"])
    export_serving.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[WARN] finetune ckpt not found (None); random weights"
    assert lines[-1].startswith(f"[export] wrote {out} (") and os.path.exists(out)
    monkeypatch.setattr(sys, "argv", ["export_serving", "--load", str(out), "--batch", "3",
                                      "--iters", "2"])
    export_serving.main()
    served = capsys.readouterr().out.splitlines()
    assert served[0] == f"[serve] {out}: in (3, {T}, {S}, {S}, 3) -> logits (3, {C}), finite=True"
    assert served[1].startswith("[serve] ") and served[1].endswith("batch 3, 2 iters)")


def test_export_cli_writes_an_artifact_per_platform(exported, tmp_path, monkeypatch, capsys):
    """``--platforms cpu`` writes ``<out>.cpu.pt2``, whose logits are the
    live model's; ``--load <out>`` picks the file of this host's platform."""
    _, _, cfg, _ = exported
    import yaml

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "o" / "clf.pt2"
    monkeypatch.setattr(sys, "argv", ["export_serving", "--config", str(cfg_path), "--base", "",
                                      "--out", str(out), "--device", "cpu",
                                      "--platforms", "cpu"])
    export_serving.main()
    cpu_path = tmp_path / "o" / "clf.cpu.pt2"
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith(f"[export] wrote {cpu_path} (") and not os.path.exists(out)
    assert export_serving.pick_artifact(str(out)) == str(cpu_path)
    program = torch.export.load(str(cpu_path))
    assert export_serving.artifact_input(program)[1] == torch.device("cpu")
    live = run_dynamic.load_classifier(cfg, torch.float32, torch.device("cpu"), lambda m: None)
    clip = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, T, S, S, 3)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(program.module()(clip).numpy(), live(clip).numpy(),
                                   rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(sys, "argv", ["export_serving", "--load", str(out), "--batch", "2",
                                      "--iters", "1"])
    export_serving.main()
    served = capsys.readouterr().out.splitlines()
    assert served[0] == (f"[serve] {cpu_path}: in (2, {T}, {S}, {S}, 3) -> logits "
                         f"(2, {C}), finite=True")


@pytest.mark.parametrize("platforms", [["tpu"], ["cpu", "gpu"]])
def test_export_refuses_an_unknown_platform(tmp_path, monkeypatch, platforms):
    """A name that is not a torch device type raises before any export."""
    out = tmp_path / "clf.pt2"
    monkeypatch.setattr(sys, "argv", ["export_serving", "--config", "unread.yaml",
                                      "--out", str(out), "--platforms", *platforms])
    with pytest.raises(ValueError, match="unknown platform"):
        export_serving.main()
    with pytest.raises(ValueError, match="unknown platform"):
        export_serving.export_platforms({}, "cpu", platforms)
    assert not list(tmp_path.iterdir())
