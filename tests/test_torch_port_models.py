"""The port's MobileViT-S classifier and early-exit functions against the
JAX package, in fp32 on the CPU.

The classifier is the full MobileViT-S (widths fixed; embed_dim 32 keeps it
cheap) with JAX ``init_model`` weights carried over by the converter, BN
running statistics made non-trivial first. One comparison runs the JAX model
on its Pallas flash-attention path (interpret mode), one on the default
path; the 112x112 check exercises L = 196/64/16 and the 7x7 -> 8x8 pad.
Tolerance: atol = rtol = 1e-4 after ~40 fp32 layers summed in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.models import dynamic as jdyn
from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu_torch.models import dynamic as tdyn
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as teng
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    classifier_state_dict_from_flax, flatten_variables, unflatten_variables)

torch.set_num_threads(2)  # six test workers share the host

NUM_CLASSES, EMBED_DIM = 5, 32
NET_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def variables():
    model = jeng.build_model(NUM_CLASSES, EMBED_DIM)
    v = jax.tree.map(np.asarray, jeng.init_model(model, jax.random.key(0),
                                                 (1, 2, 32, 32, 3)))
    rng = np.random.default_rng(0)
    flat = flatten_variables(v)
    for key, a in flat.items():
        if key.endswith("/mean"):
            flat[key] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif key.endswith("/var"):
            flat[key] = rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
    return unflatten_variables(flat)


@pytest.fixture(scope="module")
def port_model(variables):
    model = teng.build_model(NUM_CLASSES, EMBED_DIM)
    model.load_state_dict(classifier_state_dict_from_flax(variables))
    return model


def _jax_outputs(model, variables, clip):
    """(frame embeddings [B*T, D], logits [B, K]) in one compile."""
    B, T = clip.shape[:2]

    def f(v, c):
        emb = model.apply(v, c.reshape((B * T,) + c.shape[2:]), method="frame_embedding")
        logits = model.apply(v, emb.reshape(B, T, -1).mean(1), method="classify_embedding")
        return emb, logits

    emb, logits = jax.jit(f)(variables, jnp.asarray(clip))
    return np.asarray(emb), np.asarray(logits)


@pytest.mark.parametrize("attn_impl,size", [
    ("pallas", 32),   # the JAX reference on its Pallas kernel (interpret mode)
    (None, 32),
    (None, 112),      # L = 196 / 64 (7x7 padded to 8x8) / 16
])
def test_classifier_matches_jax(variables, port_model, attn_impl, size):
    clip = np.random.default_rng(size).standard_normal(
        (1, 2, size, size, 3), dtype=np.float32)
    jmodel = jeng.build_model(NUM_CLASSES, EMBED_DIM, attn_impl=attn_impl)
    ref_emb, ref_logits = _jax_outputs(jmodel, variables, clip)
    x = torch.from_numpy(clip)
    with torch.no_grad():
        emb = port_model.frame_embedding(x.reshape(2, size, size, 3)).numpy()
        logits = port_model(x).numpy()
        video_emb = port_model.video_embedding(x).numpy()
    np.testing.assert_allclose(emb, ref_emb, **NET_TOL)
    np.testing.assert_allclose(video_emb, ref_emb.mean(0, keepdims=True), **NET_TOL)
    np.testing.assert_allclose(logits, ref_logits, **NET_TOL)


def test_build_model_names_the_roadmap_item_for_unported_backbones():
    # the TinyViT backbone, once ROADMAP item 9, is ported: its embedding is
    # the tapped stage's width, whatever embed_dim says
    tiny = teng.build_model(4, 32, backbone="tinyvit")
    assert tiny.backbone.embed_dim == 384 and tiny.head.weight.shape == (4, 384)
    with pytest.raises(ValueError, match="Unknown backbone"):
        teng.build_model(4, 32, backbone="resnet")
    # train mode is ported (pipeline-B slice): batch statistics, and the
    # running ones move
    model = teng.build_model(4, 32)
    model.train()
    before = model.backbone.stem.bn.running_mean.clone()
    logits = model(torch.rand(1, 2, 32, 32, 3))
    assert logits.shape == (1, 4) and torch.isfinite(logits).all()
    assert not torch.equal(model.backbone.stem.bn.running_mean, before)


def test_init_model_is_seeded():
    a = teng.init_model(teng.build_model(4, 32), torch.Generator().manual_seed(3))
    b = teng.init_model(teng.build_model(4, 32), torch.Generator().manual_seed(3))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb), ka
    w = a.backbone.stem.conv.weight
    fan_in = 3 * 3 * 3
    assert abs(float(w.detach().std()) - (1 / fan_in) ** 0.5) < 0.1 * (1 / fan_in) ** 0.5


def test_motion_gating_matches_jax():
    clip = np.random.default_rng(1).standard_normal((3, 9, 6, 6, 3), dtype=np.float32)
    np.testing.assert_allclose(tdyn.motion_scores_l1(torch.from_numpy(clip)).numpy(),
                               np.asarray(jdyn.motion_scores_l1(jnp.asarray(clip))),
                               atol=1e-6, rtol=1e-6)
    for k in (1, 4, 9, 12):
        sel, idx = tdyn.select_topk_frames(torch.from_numpy(clip), k)
        jsel, jidx = jdyn.select_topk_frames(jnp.asarray(clip), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    sel, idx = tdyn.select_topk_frames(torch.from_numpy(clip), 4, "random",
                                       generator=torch.Generator().manual_seed(0))
    assert sel.shape == (3, 4, 6, 6, 3) and (np.diff(idx.numpy(), axis=1) > 0).all()


# the knob grid of tests/test_dynamic.py's batched-vs-streaming test
KNOBS = [(0.0, 1, None, 1), (0.35, 2, None, 1), (0.6, 4, 5, 2),
         (0.99, 3, None, 3), (1.01, 1, None, 1)]  # 1.01: nobody ever exits


def test_early_exit_matches_jax_and_streaming_equals_batched():
    """Same embeddings and classifier in both packages: used_frames exactly
    equal, final_conf/logits within 1e-5 of JAX; the port's streaming and
    batched paths agree exactly."""
    B, T, D, K = 5, 7, 6, 3
    rng = np.random.default_rng(0)
    w = rng.normal(size=(D, K)).astype(np.float32)
    clip = (rng.normal(size=(B, T, 1, 1, D)) * 2).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)

    def j_embed(frames):
        return jnp.tanh(frames[:, 0, 0, :] * 1.7)

    def t_embed(frames):
        return torch.tanh(frames[:, 0, 0, :] * 1.7)

    for thr, mf, mx, fs in KNOBS:
        kw = dict(min_frames=mf, max_frames=mx, frame_step=fs)
        msg = f"thr={thr} kw={kw}"
        jl, js = jax.jit(lambda c: jdyn.streaming_early_exit(
            j_embed, lambda e: e @ jw, c, thr, **kw))(jnp.asarray(clip))
        jbl, jbs = jax.jit(lambda c: jdyn.early_exit_batched(
            j_embed, lambda e: e @ jw, c, thr, **kw))(jnp.asarray(clip))
        tl, ts = tdyn.streaming_early_exit(t_embed, lambda e: e @ tw,
                                           torch.from_numpy(clip), thr, **kw)
        tbl, tbs = tdyn.early_exit_batched(t_embed, lambda e: e @ tw,
                                           torch.from_numpy(clip), thr, **kw)
        for used in (js.used_frames, jbs.used_frames, tbs.used_frames):
            np.testing.assert_array_equal(ts.used_frames.numpy(), np.asarray(used),
                                          err_msg=msg)
        np.testing.assert_allclose(ts.final_conf.numpy(), np.asarray(js.final_conf),
                                   atol=1e-5, rtol=0, err_msg=msg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0,
                                   err_msg=msg)
        np.testing.assert_allclose(tbl.numpy(), np.asarray(jbl), atol=1e-5, rtol=0,
                                   err_msg=msg)
        torch.testing.assert_close(tbl, tl, atol=0, rtol=0, msg=msg)
        torch.testing.assert_close(tbs.final_conf, ts.final_conf, atol=0, rtol=0,
                                   msg=msg)
        assert ts.used_frames.dtype == torch.int32
