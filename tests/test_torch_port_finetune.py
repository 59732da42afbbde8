"""The port's finetune slice against the JAX package, in fp32 on the CPU, at
toy widths: TinyViT dims (8, 16, 24, 32), B=2 clips of T=4 frames at 32x32,
4 classes.

Weights are the JAX package's, carried over by the converter after every
param is moved off its init and the BatchNorm statistics made non-trivial.
Random streams differ across frameworks, so the train steps run with
stochastic depth off: a test-local flax backbone with the encoder tree of
``TinyViTBackbone`` (``backbone/encoder``; depths (1, 1, 1), rate 0), and
the same encoder in the port's ``TinyViTBackbone``.

Tolerances: logits 1e-5 relative (of the largest logit); losses and
gradients 1e-4 (gradients also 1e-4 of the largest in absolute terms);
Adam's first update is about lr * sign(g), so new params are compared where
|g| exceeds 1e-3 of its group's largest, to 1e-6; BN statistics 1e-4;
loaded and frozen tensors exactly.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ssl_vit_video_analytics_tpu.entry import evaluate as jax_evaluate
from ssl_vit_video_analytics_tpu.entry import train_finetune as jax_train_finetune
from ssl_vit_video_analytics_tpu.entry.train_ssl_mae import build_model as jax_build_mae
from ssl_vit_video_analytics_tpu.models.classifier import VideoClassifier as JaxClassifier
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.ops.preprocess import normalize_clip as jax_normalize_clip
from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu.utils import checkpoint as jckpt
from ssl_vit_video_analytics_tpu.utils import metrics as jmetrics
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import evaluate, train_finetune, train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.models.classifier import VideoClassifier
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT, TinyViTBackbone
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as teng
from ssl_vit_video_analytics_tpu_torch.train import state as tstate
from ssl_vit_video_analytics_tpu_torch.utils import checkpoint as tckpt
from ssl_vit_video_analytics_tpu_torch.utils import metrics as tmetrics
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    classifier_state_dict_from_flax, encoder_state_dict_from_flax, flatten_variables,
    unflatten_variables)
from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

torch.set_num_threads(2)  # six test workers share the host

B, T, S, C = 2, 4, 32, 4
DIMS = (8, 16, 24, 32)
STEP_DEPTHS, STEP_HEADS = (1, 1, 1, 1), (1, 2, 2, 2)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
FT_CFG = {"learning_rate": 1e-3, "head_lr": 1e-2, "backbone_lr": 2e-3, "weight_decay": 0.05}
# (mode, freeze_backbone, grad_clip): the optimizer of each step tested
STEPS = {"ft_random": ("ft_random", False, None), "linear_probe": ("linear_probe", True, None),
         "ft_ssl": ("ft_ssl", False, None), "two_stage_frozen": ("two_stage", True, None),
         "two_stage_unfrozen": ("two_stage", False, None),
         "two_stage_clipped": ("two_stage", False, 0.05)}


def _perturb(v, seed):
    """Every param moved off its init, BN statistics made non-trivial."""
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


def _clip_u8(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)


def _labels(seed):
    return np.random.default_rng(seed).integers(0, C, (B,), dtype=np.int32)


# --- the classifier over the real TinyViTBackbone, eval mode ---

_EVAL = {}


def _jax_tinyvit_classifier(stage_limit):
    """The JAX classifier, its perturbed variables and its jitted eval step."""
    if stage_limit not in _EVAL:
        model = jeng.build_model(C, 24, backbone="tinyvit",
                                 backbone_kwargs={"embed_dims": DIMS,
                                                  "stage_limit": stage_limit})
        variables = _perturb(jeng.init_model(model, jax.random.key(0), (B, T, S, S, 3)),
                             stage_limit)
        _EVAL[stage_limit] = (model, variables, jeng.make_eval_step(model))
    return _EVAL[stage_limit]


def _port_classifier(variables, stage_limit=3):
    model = teng.build_model(C, 24, backbone="tinyvit",
                             backbone_kwargs={"embed_dims": DIMS, "stage_limit": stage_limit})
    model.load_state_dict(classifier_state_dict_from_flax(variables))
    return model


@pytest.mark.parametrize("stage_limit", [3, 4])
def test_tinyvit_classifier_eval_logits_match_jax(stage_limit):
    model, variables, eval_step = _jax_tinyvit_classifier(stage_limit)
    clip = _clip_u8(1)
    jstate_ = jstate.create_train_state(variables["params"], optax.identity(),
                                        batch_stats=variables["batch_stats"])
    ref = np.asarray(eval_step(jstate_, {"clip": jnp.asarray(clip)}))
    port = _port_classifier(variables, stage_limit)
    assert port.backbone.embed_dim == DIMS[stage_limit - 1]
    assert len(port.backbone.encoder.stages) == stage_limit
    got = teng.make_eval_step(port)({"clip": torch.from_numpy(clip)}).numpy()
    assert got.shape == (B, C)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_evaluate_counts_valid_rows_only_as_jax():
    """Two batches of the same split, the second a padded tail (its last row
    repeats and is masked out): top-1 and top-5 (clamped to 4 classes)."""
    model, variables, eval_step = _jax_tinyvit_classifier(3)
    jst = jstate.create_train_state(variables["params"], optax.identity(),
                                    batch_stats=variables["batch_stats"])
    clips = [_clip_u8(2), _clip_u8(3)]
    clips[1][1] = clips[1][0]
    labels = [np.array([0, 3], np.int32), np.array([1, 1], np.int32)]
    valids = [np.array([True, True]), np.array([True, False])]
    ref = jeng.evaluate(eval_step, jst, [
        {"clip": jnp.asarray(c), "label": jnp.asarray(y), "valid": jnp.asarray(v)}
        for c, y, v in zip(clips, labels, valids)], ks=(1, 5))
    port = _port_classifier(variables)
    got = teng.evaluate(teng.make_eval_step(port), [
        {"clip": torch.from_numpy(c), "label": torch.from_numpy(y),
         "valid": torch.from_numpy(v)} for c, y, v in zip(clips, labels, valids)], ks=(1, 5))
    assert got == pytest.approx(ref, abs=0)
    assert got["top5"] == 1.0


# --- load_pretrained_ssl ---

@functools.lru_cache(maxsize=None)
def _jax_encoder_blob(dims=DIMS):
    """A perturbed pipeline-B encoder-only blob, as entry/train_ssl_mae saves
    (built once per widths; callers do not modify it)."""
    cfg = {"dataset": {"clip_len": T, "image_size": S},
           "model": {"embed_dims": list(dims), "decoder_embed_dim": 16, "decoder_depth": 1,
                     "decoder_num_heads": 2, "use_checkpoint": False}}
    mae = jax_build_mae(cfg, jnp.float32)
    v = jax.jit(lambda k: mae.init(k, jnp.zeros((B, T, S, S, 3)),
                                   jnp.zeros((B, T, (S // 8) ** 2), bool)))(jax.random.key(1))
    v = _perturb({"params": {"encoder": v["params"]["encoder"]},
                  "batch_stats": {"encoder": v["batch_stats"]["encoder"]}}, 7)
    return v


def test_load_pretrained_ssl_from_jax_encoder_npz_matches_jax(tmp_path):
    _, variables, _ = _jax_tinyvit_classifier(3)
    blob = _jax_encoder_blob()
    path = tmp_path / "encoder.npz"
    np.savez(path, **flatten_variables(blob))
    ref = classifier_state_dict_from_flax(jeng.load_pretrained_ssl(variables, blob))

    port = _port_classifier(variables)
    head = {k: v.clone() for k, v in port.state_dict().items() if k.startswith("head.")}
    ssl_state = tckpt.read_checkpoint(str(path))
    assert ssl_state and all(k.startswith("encoder.") for k in ssl_state)
    assert teng.load_pretrained_ssl(port, ssl_state) is port
    got = port.state_dict()
    assert set(got) == set(ref)
    for k, v in got.items():
        torch.testing.assert_close(v, ref[k], atol=0, rtol=0, msg=k)
    for k, v in head.items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)
    # it changed the backbone
    before = classifier_state_dict_from_flax(variables)
    assert any(not torch.equal(before[k], got[k]) for k in got if k.startswith("backbone."))


def test_load_pretrained_ssl_raises_on_mismatch():
    _, variables, _ = _jax_tinyvit_classifier(3)
    other = encoder_state_dict_from_flax(_jax_encoder_blob((8, 16, 32, 40)))
    port = _port_classifier(variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match="not match"):
        teng.load_pretrained_ssl(port, other)
    good = encoder_state_dict_from_flax(_jax_encoder_blob())
    with pytest.raises(ValueError, match="not match"):  # a missing tensor
        teng.load_pretrained_ssl(port, {k: v for k, v in list(good.items())[1:]})
    for k, v in port.state_dict().items():  # nothing loaded
        torch.testing.assert_close(v, before[k], atol=0, rtol=0, msg=k)
    # JAX raises on the same mismatch
    with pytest.raises(ValueError, match="not match"):
        jeng.load_pretrained_ssl(variables, _jax_encoder_blob((8, 16, 32, 40)))


# --- one train step per mode, against make_train_step with build_finetune_tx ---

class _StepBackbone(fnn.Module):
    """TinyViTBackbone's tree (``encoder``, stage limit 3) with depths
    (1, 1, 1) and no stochastic depth, for comparable train steps."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        feat = JaxTinyViT(embed_dims=DIMS, depths=STEP_DEPTHS, num_heads=STEP_HEADS,
                          drop_path_rate=0.0, use_checkpoint=False, name="encoder")(
            x, train=train, stage_limit=3)
        return feat, jnp.mean(feat, axis=(1, 2))


_STEP = {}


def _step_setup():
    """The JAX step classifier, its perturbed variables, a perturbed encoder
    blob of the same widths, and a jitted gradient of the JAX step's loss."""
    if not _STEP:
        model = JaxClassifier(backbone=_StepBackbone(), num_classes=C)
        v = _perturb(jeng.init_model(model, jax.random.key(3), (B, T, S, S, 3)), 4)
        blob = _perturb({"params": {"encoder": v["params"]["backbone"]["encoder"]},
                         "batch_stats": {"encoder": v["batch_stats"]["backbone"]["encoder"]}},
                        5)

        @jax.jit
        def grads(params, batch_stats, clip, labels):
            def loss_fn(p):
                out, _ = model.apply({"params": p, "batch_stats": batch_stats},
                                     jax_normalize_clip(clip), train=True,
                                     mutable=["batch_stats"])
                return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
                    out.astype(jnp.float32), labels))
            return jax.grad(loss_fn)(params)

        _STEP.update(model=model, variables=v, blob=blob, grads=grads, fns={})
    return _STEP


def _jax_step(name, params):
    """The JAX step of ``STEPS[name]`` (built once per optimizer)."""
    mode, freeze, clip = STEPS[name]
    s = _step_setup()
    key = (mode if mode == "two_stage" else "single", freeze, clip)
    if key not in s["fns"]:
        tx = jeng.build_finetune_tx({**FT_CFG, "grad_clip": clip}, mode, params, freeze)
        s["fns"][key] = (tx, jeng.make_train_step(s["model"], tx))
    return s["fns"][key]


def _port_step_model(variables):
    model = VideoClassifier(TinyViTBackbone(embed_dims=DIMS), C)
    model.backbone.encoder = TinyViT(embed_dims=DIMS, depths=STEP_DEPTHS,
                                     num_heads=STEP_HEADS, drop_path_rate=0.0,
                                     use_checkpoint=False, num_stages=3)
    model.load_state_dict(classifier_state_dict_from_flax(variables))
    return model


def _as_port(params, batch_stats):
    return classifier_state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, batch_stats)})


def _groups(model, mode, freeze):
    """Parameter names by optimizer group, as build_finetune_tx groups them
    (frozen ones in none)."""
    names = [n for n, _ in model.named_parameters()]
    backbone = [n for n in names if n.startswith("backbone.")]
    head = [n for n in names if not n.startswith("backbone.")]
    if mode == "two_stage":
        return {"head": head} if freeze else {"head": head, "backbone": backbone}
    return {"train": head if freeze else names}


def _run_both(name, variables, clip, labels):
    """One step of each framework from ``variables``. Returns the JAX new
    state and metrics, the port model, its train state and metrics."""
    mode, freeze, _ = STEPS[name]
    s = _step_setup()
    if mode == "ft_ssl":
        variables = jeng.load_pretrained_ssl(variables, s["blob"])
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx, jstep = _jax_step(name, params)
    jst = jstate.create_train_state(params, tx,
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             variables["batch_stats"]))
    new_jst, jm = jstep(jst, {"clip": jnp.asarray(clip), "label": jnp.asarray(labels)})

    port = _port_step_model(s["variables"])
    if mode == "ft_ssl":
        teng.load_pretrained_ssl(port, encoder_state_dict_from_flax(s["blob"]))
    _, _, clip_norm = STEPS[name]
    state = tstate.create_train_state(port, teng.build_finetune_tx(
        {**FT_CFG, "grad_clip": clip_norm}, mode, port, freeze))
    step = teng.make_train_step(port)
    state, m = step(state, {"clip": torch.from_numpy(clip), "label": torch.from_numpy(labels)},
                    torch.Generator().manual_seed(0))
    return new_jst, jm, port, state, m


@pytest.mark.parametrize("name", list(STEPS))
def test_one_step_per_mode_matches_jax(name):
    """Loss, top-1, the gradient each group's Adam saw (clipped by the
    group's own norm), new params, BN statistics; frozen params unchanged."""
    mode, freeze, grad_clip = STEPS[name]
    s = _step_setup()
    variables = s["variables"]
    if mode == "ft_ssl":
        variables = jeng.load_pretrained_ssl(variables, s["blob"])
    clip, labels = _clip_u8(10), _labels(11)
    before = classifier_state_dict_from_flax(variables)
    new_jst, jm, port, state, m = _run_both(name, s["variables"], clip, labels)

    assert state.step == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(m["top1"]) == float(jm["top1"])
    assert float(m["top5"]) == float(jm["top5"])
    ref_new = _as_port(new_jst.params, new_jst.batch_stats)
    ref_g = _as_port(s["grads"](jax.tree.map(jnp.asarray, variables["params"]),
                             jax.tree.map(jnp.asarray, variables["batch_stats"]),
                             jnp.asarray(clip), jnp.asarray(labels)),
                     new_jst.batch_stats)
    opt = tstate.adamw_of(state.tx)
    assert opt.names == list(_groups(port, mode, freeze))
    named = dict(port.named_parameters())
    norms = {group: float(np.sqrt(sum(np.sum(ref_g[n].numpy().astype(np.float64) ** 2)
                                      for n in names)))
             for group, names in _groups(port, mode, freeze).items()}
    if grad_clip is not None:
        # the clip binds in both groups, and the joint norm would scale the
        # head otherwise than its own: the comparison below tells them apart
        joint = float(np.hypot(norms["head"], norms["backbone"]))
        assert grad_clip < min(norms.values())
        assert abs(1 / norms["head"] - 1 / joint) > 1e-2 / norms["head"]
    for group, names in _groups(port, mode, freeze).items():
        g = {n: ref_g[n].numpy() for n in names}
        scale = 1.0 if grad_clip is None else min(1.0, grad_clip / norms[group])
        gmax = max(float(np.abs(a).max()) for a in g.values())
        for n in names:
            p = named[n]
            seen = (opt.opt.state[p]["exp_avg"] / 0.1).numpy()
            np.testing.assert_allclose(seen, g[n] * scale, rtol=1e-4,
                                       atol=1e-4 * gmax * scale, err_msg=n)
            sure = np.abs(g[n]) > 1e-3 * gmax
            np.testing.assert_allclose(p.detach().numpy()[sure], ref_new[n].numpy()[sure],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
    trained = {n for names in _groups(port, mode, freeze).values() for n in names}
    for n, p in named.items():
        if n not in trained:  # frozen: bit-unchanged, in both
            torch.testing.assert_close(p.detach(), before[n], atol=0, rtol=0, msg=n)
            torch.testing.assert_close(ref_new[n], before[n], atol=0, rtol=0, msg=n)
    moved = 0
    for k, t in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref_new[k].numpy(), **NET_TOL, err_msg=k)
            moved += not torch.equal(t, before[k])
    assert moved > 0, "train mode must move the backbone's BN statistics, frozen or not"


def test_two_steps_across_the_two_stage_boundary_match_jax():
    """A frozen step, then the rebuild (fresh optimizer, count and step) and
    an unfrozen step, in both frameworks: the second step's Adam moments are
    the second gradient's alone."""
    s = _step_setup()
    clips, labels = (_clip_u8(20), _clip_u8(21)), (_labels(22), _labels(23))
    v0 = s["variables"]
    params = jax.tree.map(jnp.asarray, v0["params"])
    tx1, step1 = _jax_step("two_stage_frozen", params)
    jst = jstate.create_train_state(params, tx1, batch_stats=jax.tree.map(jnp.asarray,
                                                                          v0["batch_stats"]))
    jst, _ = step1(jst, {"clip": jnp.asarray(clips[0]), "label": jnp.asarray(labels[0])})
    mid = {"params": jax.tree.map(np.asarray, jst.params),
           "batch_stats": jax.tree.map(np.asarray, jst.batch_stats)}
    tx2, step2 = _jax_step("two_stage_unfrozen", jst.params)
    jst = jstate.create_train_state(jst.params, tx2, batch_stats=jst.batch_stats)
    jst, jm = step2(jst, {"clip": jnp.asarray(clips[1]), "label": jnp.asarray(labels[1])})
    assert int(jst.step) == 1
    ref_new = _as_port(jst.params, jst.batch_stats)
    ref_g = _as_port(s["grads"](jax.tree.map(jnp.asarray, mid["params"]),
                             jax.tree.map(jnp.asarray, mid["batch_stats"]),
                             jnp.asarray(clips[1]), jnp.asarray(labels[1])), mid["batch_stats"])

    port = _port_step_model(v0)
    step = teng.make_train_step(port)
    gen = torch.Generator().manual_seed(0)
    state = tstate.create_train_state(port, teng.build_finetune_tx(FT_CFG, "two_stage", port,
                                                                   True))
    state, _ = step(state, {"clip": torch.from_numpy(clips[0]),
                            "label": torch.from_numpy(labels[0])}, gen)
    first = state.tx
    state = tstate.create_train_state(port, teng.build_finetune_tx(FT_CFG, "two_stage", port,
                                                                   False))
    state, m = step(state, {"clip": torch.from_numpy(clips[1]),
                            "label": torch.from_numpy(labels[1])}, gen)
    assert state.tx is not first and state.step == 1 and state.tx.count == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    named = dict(port.named_parameters())
    for group, names in _groups(port, "two_stage", False).items():
        gmax = max(float(np.abs(ref_g[n].numpy()).max()) for n in names)
        for n in names:
            p = named[n]
            seen = (state.tx.opt.state[p]["exp_avg"] / 0.1).numpy()
            np.testing.assert_allclose(seen, ref_g[n].numpy(), rtol=1e-4, atol=1e-4 * gmax,
                                       err_msg=n)
            sure = np.abs(ref_g[n].numpy()) > 1e-3 * gmax
            np.testing.assert_allclose(p.detach().numpy()[sure], ref_new[n].numpy()[sure],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
    for k, t in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref_new[k].numpy(), **NET_TOL, err_msg=k)


# --- metrics and checkpoint helpers ---

def test_topk_accuracy_matches_jax():
    rng = np.random.default_rng(30)
    logits = rng.standard_normal((16, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 16).astype(np.int32)
    ref = jmetrics.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), ks=(1, 3, 5))
    got = tmetrics.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 ks=(1, 3, 5))
    assert set(got) == set(ref) == {"top1", "top3", "top5"}
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), abs=1e-7), k
    assert float(got["top5"]) == 1.0  # k clamped to the class count


def test_update_best_and_format_metrics_match_jax():
    for best, cur, key, mode in ((None, {"top1": 0.5}, "top1", "max"),
                                 ({"top1": 0.5}, {"top1": 0.4}, "top1", "max"),
                                 ({"top1": 0.5}, {"top1": 0.6}, "top1", "max"),
                                 ({"loss": 0.5}, {"loss": 0.4}, "loss", "min"),
                                 ({"other": 1}, {"loss": 0.4}, "loss", "min")):
        assert tmetrics.update_best(best, cur, key, mode) == \
            jmetrics.update_best(best, cur, key, mode)
    row = {"loss": 0.123456, "top1": torch.tensor(0.5), "mode": "two_stage", "epoch": 3}
    assert tmetrics.format_metrics(row) == jmetrics.format_metrics(
        {**row, "top1": jnp.asarray(0.5)}) == \
        "loss=0.1235 top1=0.5000 mode=two_stage epoch=3.0000"


def test_best_ckpt_name_matches_jax():
    for args in (("finetune", 28, "top1", 0.67154), ("finetune", 1, "top1", 1.0)):
        assert tckpt.best_ckpt_name(*args) == jckpt.best_ckpt_name(*args)


def test_checkpoint_restore_suffix_meta_and_retention(tmp_path):
    sd = {"w": torch.arange(3.0)}
    path = tckpt.save_checkpoint(str(tmp_path), "best", sd, meta={"top1": 0.5})
    assert path.endswith("best.pt")
    for name in (path, str(tmp_path / "best")):
        out = tckpt.restore_checkpoint(name)
        assert out["top1"] == 0.5
        torch.testing.assert_close(out["w"], sd["w"])
        assert set(tckpt.read_checkpoint(name)) == {"w"}
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "missing"))
    for e in (1, 2, 10, 3):
        tckpt.save_checkpoint(str(tmp_path), f"ckpt_epoch_{e}", sd, meta={"epoch": e})
    (tmp_path / "ckpt_epoch_99.pt.123.tmp").write_bytes(b"")  # an unfinished write
    assert tckpt.find_latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_epoch_10.pt")
    deleted = tckpt.keep_last_n_checkpoints(str(tmp_path), 2)
    assert sorted(os.path.basename(p) for p in deleted) == ["ckpt_epoch_1.pt",
                                                            "ckpt_epoch_2.pt"]
    left = sorted(os.listdir(tmp_path))
    assert "ckpt_epoch_3.pt" in left and "ckpt_epoch_10.pt.meta.json" in left
    assert "ckpt_epoch_1.pt.meta.json" not in left and "best.pt" in left
    assert tckpt.find_latest_checkpoint(str(tmp_path / "nowhere")) is None


# --- the entries at toy size ---

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftdata")
    return make_synthetic_dataset(str(root), num_classes=C, videos_per_class=3,
                                  num_frames=12, image_size=S, seed=0)


@pytest.fixture(scope="module")
def pretrained(data, tmp_path_factory):
    """An encoder checkpoint from the port's pipeline-B pretraining."""
    out = tmp_path_factory.mktemp("pre")
    cfg = {"seed": 42, "device": {"compute_dtype": "float32"},
           "dataset": {"train_split": data["train"], "clip_len": T, "stride": 2,
                       "image_size": S, "backend": "packed"},
           "model": {"embed_dims": list(DIMS), "decoder_embed_dim": 16, "decoder_depth": 1,
                     "decoder_num_heads": 2, "use_checkpoint": False},
           "training": {"epochs": 1, "batch_size": 4, "save_dir": str(out), "save_every": 1,
                        "lr": 1e-2, "warmup_epochs": 0},
           "paths": {"split_root": ""}}
    # two steps: the first update of the warm-up schedule has lr 0
    train_ssl_mae.run(cfg, log=lambda *_: None, device="cpu", max_steps=2)
    return tckpt.find_latest_checkpoint(str(out))


def _ft_cfg(data, tmp_path, **over):
    cfg = {"seed": 42, "device": {"compute_dtype": "float32"},
           "dataset": {"train_split": data["train"], "val_split": data["val"],
                       "num_classes": C, "clip_len": T, "stride": 2, "image_size": S,
                       "backend": "packed", "device_resident": True},
           "model": {"backbone": "tinyvit", "embed_dim": 256,
                     "backbone_kwargs": {"embed_dims": list(DIMS)}, "pretrained_ssl": None},
           "training": {"epochs": 2, "batch_size": 4, "learning_rate": 1e-3, "head_lr": 1e-2,
                        "stage1_epochs": 1, "log_interval": 1},
           "evaluation": {"topk": [1, 5]},
           "paths": {"save_dir": str(tmp_path / "ft"), "split_root": "",
                     "log_dir": str(tmp_path / "logs"), "result_dir": str(tmp_path / "res")}}
    for key, value in over.items():
        section, name = key.split("__")
        cfg[section][name] = value
    return cfg


def test_pretrained_ssl_pt_loads_into_tinyvit_classifier(pretrained):
    """The port's pretraining checkpoint fills every backbone tensor."""
    ssl_state = tckpt.read_checkpoint(pretrained[:-len(".pt")])
    model = teng.build_model(C, 256, backbone="tinyvit",
                             backbone_kwargs={"embed_dims": list(DIMS)})
    teng.load_pretrained_ssl(model, ssl_state)
    got = model.backbone.state_dict()
    assert set(got) == set(ssl_state)
    for k, v in got.items():
        torch.testing.assert_close(v, ssl_state[k], atol=0, rtol=0, msg=k)


def test_train_finetune_two_stage_from_port_pretraining(data, tmp_path, pretrained):
    logs, steps = [], []
    cfg = _ft_cfg(data, tmp_path, model__pretrained_ssl=pretrained[:-len(".pt")])
    out = train_finetune.run(cfg, mode="two_stage", log=logs.append, device="cpu",
                             on_step=lambda i, state, m: steps.append((i, state.step)))
    assert any(m.startswith("[INFO] Loaded SSL pretrain from") for m in logs)
    assert any("two_stage: unfreeze backbone and rebuild optimizer" in m for m in logs)
    assert any("device-resident store" in m for m in logs)
    assert steps == [(1, 1), (2, 2), (3, 1), (4, 2)]  # 8 clips, batch 4; step reset
    best = out["best_ckpt"]
    assert best is not None and os.path.isfile(best)
    top1 = float(os.path.basename(best).split("_top1_")[1][:-len(".pt")])
    assert top1 == pytest.approx(out["best_top1"], abs=5e-5) and top1 > 0
    assert os.path.isfile(os.path.join(os.path.dirname(best), "best.pt"))
    rows = read_csv_dicts(os.path.join(cfg["paths"]["save_dir"], "two_stage", "metrics.csv"))
    assert [r["epoch"] for r in rows] == ["1", "2"]
    # the best checkpoint reproduces its epoch's val top-1 through entry.evaluate
    ev = evaluate.run(cfg, os.path.join(cfg["paths"]["save_dir"], "two_stage", "best"),
                      None, log=lambda *_: None, measure_latency=False, device="cpu")
    assert ev["acc"]["top1"] == pytest.approx(out["best_top1"], abs=1e-9)


def test_train_finetune_ft_ssl_loads_the_port_encoder(data, tmp_path, pretrained):
    """port pretrain -> ft_ssl: after one step (lr 1e-3) the backbone's
    params lie within an Adam step of the encoder's, and the classifier's own
    random init does not."""
    cfg = _ft_cfg(data, tmp_path, model__pretrained_ssl=pretrained, training__epochs=1)
    ssl_state = tckpt.read_checkpoint(pretrained)
    init = teng.init_model(teng.build_model(C, 256, backbone="tinyvit",
                                            backbone_kwargs={"embed_dims": list(DIMS)}),
                           torch.Generator().manual_seed(42))
    seen = {}

    def on_step(i, state, m):
        if i == 1:
            for k, p in state.model.backbone.named_parameters():
                seen[k] = float((p.detach() - ssl_state[k]).abs().max())

    train_finetune.run(cfg, mode="ft_ssl", log=lambda *_: None, device="cpu", on_step=on_step)
    assert seen and max(seen.values()) <= 2e-3
    assert max(float((p.detach() - ssl_state[k]).abs().max())
               for k, p in init.backbone.named_parameters()) > 5e-3


def test_train_finetune_missing_pretrained_ssl_fails_hard(data, tmp_path):
    cfg = _ft_cfg(data, tmp_path, model__pretrained_ssl=str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        train_finetune.run(cfg, mode="ft_ssl", log=lambda *_: None, device="cpu")


def test_entries_write_the_jax_csv_columns(data, tmp_path):
    """metrics.csv and evaluate.csv headers equal the JAX entries' for the
    same config (batch 16 > 8 clips: no train step, one validation)."""
    cfg = _ft_cfg(data, tmp_path, training__batch_size=16, training__epochs=1,
                  model__backbone="mobilevit_s", model__embed_dim=32,
                  dataset__device_resident=False, device__data_parallel=False)
    cfg["model"].pop("backbone_kwargs")
    jcfg = {**cfg, "paths": {**cfg["paths"], "save_dir": str(tmp_path / "jft"),
                             "result_dir": str(tmp_path / "jres")}}
    train_finetune.run(cfg, mode="linear_probe", log=lambda *_: None, device="cpu")
    jax_train_finetune.run(jcfg, mode="linear_probe", log=lambda *_: None)
    port_csv = os.path.join(cfg["paths"]["save_dir"], "linear_probe", "metrics.csv")
    jax_csv = os.path.join(jcfg["paths"]["save_dir"], "linear_probe", "metrics.csv")
    with open(port_csv) as a, open(jax_csv) as b:
        assert a.readline() == b.readline() == "epoch,mode,train_loss,val_top1,val_top5\n"
    assert [r["mode"] for r in read_csv_dicts(port_csv)] == ["linear_probe"]
    ev = evaluate.run(cfg, None, None, log=lambda *_: None, measure_latency=False,
                      device="cpu")
    jev = jax_evaluate.run(jcfg, None, None, log=lambda *_: None, measure_latency=False)
    port_rows, jax_rows = read_csv_dicts(ev["csv"]), read_csv_dicts(jev["csv"])
    assert list(port_rows[0]) == list(jax_rows[0])
    assert port_rows[0]["n_samples"] == jax_rows[0]["n_samples"] == str(C)
