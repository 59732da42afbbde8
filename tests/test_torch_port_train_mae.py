"""The port's pipeline C (feature-space token MAE) against the JAX package,
in fp32 on the CPU, at toy widths: the four-stage TinyViT at dims (8, 16,
24, 32), depths (1, 1, 1, 1), heads (1, 2, 2, 2), stochastic depth off; a
decoder 16 wide with 1 block of 2 heads; B=2 clips of T=4 frames at 32x32,
whose 2x2 stage-4 maps pool to 3x3 tokens (torch's overlapping bins).

Weights are the JAX package's, carried over by
``token_mae_state_dict_from_flax`` after every param is moved off its init
and the BatchNorm statistics made non-trivial. Random streams differ across
frameworks, so the step takes the JAX step's own token mask and flips (its
key split as the JAX step splits it).

Tolerances: forwards 1e-5 of the largest entry in eval mode and 1e-4 in
train mode (batch statistics over 8 frames down to 2x2 maps); losses,
statistics and Adam's moments 1e-4 (gradients also 1e-4 of the largest in
absolute terms); new params where |g| exceeds 1e-4 of the largest, to
1e-4; BN statistics 1e-4; the optimizer against optax 1e-6; a resumed run
bit-equal to an uninterrupted one.
"""
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_vit_video_analytics_tpu.data import loader as jloader
from ssl_vit_video_analytics_tpu.data import masking as jmasking
from ssl_vit_video_analytics_tpu.models.layers import adaptive_avg_pool_nhwc as jax_pool
from ssl_vit_video_analytics_tpu.models.mae import MAEDecoder as JaxMAEDecoder
from ssl_vit_video_analytics_tpu.models.mae import TinyViTMAE as JaxTinyViTMAE
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.train import losses as jlosses
from ssl_vit_video_analytics_tpu.train import mae_engine as jeng
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu_torch.data import loader as tloader
from ssl_vit_video_analytics_tpu_torch.data import masking as tmasking
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import sanity_check_mae, train_mae
from ssl_vit_video_analytics_tpu_torch.models.layers import adaptive_avg_pool_nhwc
from ssl_vit_video_analytics_tpu_torch.models.mae import MAEDecoder, TinyViTMAE
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
from ssl_vit_video_analytics_tpu_torch.train import losses as tlosses
from ssl_vit_video_analytics_tpu_torch.train import mae_engine as teng
from ssl_vit_video_analytics_tpu_torch.train import state as tstate
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import restore_checkpoint
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    flatten_variables, state_dict_from_flax, token_mae_state_dict_from_flax,
    unflatten_variables)

torch.set_num_threads(2)  # six test workers share the host

REPO = pathlib.Path(__file__).resolve().parents[1]
B, T, S = 2, 4, 32
POOL = 3
P = POOL ** 2
DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)
DEC_DIM, DEC_DEPTH, DEC_HEADS = 16, 1, 2
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
LR, CLIP, BETAS = 1e-3, 1.0, (0.9, 0.95)


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


def _jax_model():
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, use_checkpoint=False,
                     drop_path_rate=0.0)
    return JaxTinyViTMAE(encoder=enc, stage4_pool=POOL, decoder_dim=DEC_DIM,
                         decoder_depth=DEC_DEPTH, decoder_num_heads=DEC_HEADS)


def _port_model() -> TinyViTMAE:
    enc = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                  use_checkpoint=True, num_stages=4)
    return TinyViTMAE(enc, stage4_pool=POOL, decoder_dim=DEC_DIM, decoder_depth=DEC_DEPTH,
                      decoder_num_heads=DEC_HEADS)


@pytest.fixture(scope="module")
def variables():
    model = _jax_model()
    v = jax.jit(lambda k: model.init(k, jnp.zeros((B, T, S, S, 3)),
                                     jnp.zeros((B, T * P), bool)))(jax.random.key(0))
    return _perturb(v, 1)


def _token_mask(seed, mode="random", ratio=0.75):
    return np.asarray(jmasking.make_token_mask(jax.random.key(seed), B, T, P, ratio, mode))


@pytest.mark.parametrize("hw,s", [((4, 4), 2), ((7, 7), 3), ((2, 2), 3), ((6, 5), 3),
                                  ((3, 3), 3)])
def test_adaptive_avg_pool_matches_jax(hw, s):
    """torch's bins: 4 -> 2 halves, 7 -> 3 overlaps ([0,3), [2,5), [4,7)),
    2 -> 3 repeats the middle row, and an equal size is the identity."""
    x = np.random.default_rng(2).standard_normal((3,) + hw + (5,), dtype=np.float32)
    got = adaptive_avg_pool_nhwc(torch.from_numpy(x), s)
    assert got.shape == (3, s, s, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pool(jnp.asarray(x), s)), **FWD_TOL)
    if hw == (7, 7):
        np.testing.assert_allclose(got[:, 1, 1].numpy(), x[:, 2:5, 2:5].mean(axis=(1, 2)),
                                   **FWD_TOL)


def test_mae_decoder_matches_jax():
    x = np.random.default_rng(3).standard_normal((B, T * P, DIMS[-1]), dtype=np.float32)
    jdec = JaxMAEDecoder(embed_dim=DIMS[-1], decoder_dim=DEC_DIM, depth=2, num_heads=DEC_HEADS)
    v = _perturb(jax.jit(jdec.init)(jax.random.key(4), jnp.asarray(x)), 5)
    dec = MAEDecoder(DIMS[-1], DEC_DIM, 2, DEC_HEADS)
    dec.load_state_dict(state_dict_from_flax(v, dec.state_dict()))
    ref = np.asarray(jax.jit(jdec.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = dec(torch.from_numpy(x)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, **FWD_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tiny_vit_mae_rec_and_target_match_jax(variables, train):
    clip = np.random.default_rng(6).standard_normal((B, T, S, S, 3), dtype=np.float32)
    mask = _token_mask(7, "tube")
    model = _jax_model()
    if train:
        (rec, tgt), mut = jax.jit(lambda v, c, m: model.apply(
            v, c, m, train=True, mutable=["batch_stats"]))(variables, clip, mask)
        stats = mut["batch_stats"]
    else:
        rec, tgt = jax.jit(lambda v, c, m: model.apply(v, c, m))(variables, clip, mask)
        stats = variables["batch_stats"]
    port = _port_model()
    port.load_state_dict(token_mae_state_dict_from_flax(variables))
    port.train(train)
    got_rec, got_tgt = port(torch.from_numpy(clip), torch.from_numpy(mask))
    assert got_rec.shape == got_tgt.shape == (B, T * P, DIMS[-1])
    assert not got_tgt.requires_grad and got_rec.requires_grad
    for got, want in ((got_rec, rec), (got_tgt, tgt)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.detach().numpy() / scale, want / scale,
                                   **(NET_TOL if train else FWD_TOL))
    new = token_mae_state_dict_from_flax({"params": variables["params"],
                                          "batch_stats": jax.tree.map(np.asarray, stats)})
    for key, t in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), new[key].numpy(), **NET_TOL, err_msg=key)
    # the encoder gets a gradient through the unmasked tokens only
    got_rec.square().mean().backward()
    assert port.encoder.patch_embed.conv1.conv.weight.grad.abs().sum() > 0


def test_token_mae_converter_takes_attention_widths_from_the_tree():
    """TinyViT's head counts (3, 6, 12, 18) at dims (8, 16, 24, 32): the
    attention widths are heads x (dim // heads) = 12, 24, 18, not the dims,
    as TinyViT-21M's 576 / 18 = 32 a head at full width. The converter
    fills the port model of those heads, which gives JAX's outputs; a
    stray or a missing leaf raises."""
    heads = (3, 6, 12, 18)
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=heads, use_checkpoint=False,
                     drop_path_rate=0.0)
    model = JaxTinyViTMAE(encoder=enc, stage4_pool=POOL, decoder_dim=DEC_DIM,
                          decoder_depth=DEC_DEPTH, decoder_num_heads=DEC_HEADS)
    clip = np.random.default_rng(14).standard_normal((B, T, S, S, 3), dtype=np.float32)
    mask = _token_mask(15)
    v = _perturb(jax.jit(model.init)(jax.random.key(16), clip, mask), 17)
    rec, tgt = jax.jit(model.apply)(v, clip, mask)
    port = TinyViTMAE(TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=heads,
                              drop_path_rate=0.0, num_stages=4),
                      stage4_pool=POOL, decoder_dim=DEC_DIM, decoder_depth=DEC_DEPTH,
                      decoder_num_heads=DEC_HEADS).eval()
    port.load_state_dict(token_mae_state_dict_from_flax(v))
    assert port.encoder.stages[3].tblocks[0].attn.qkv.weight.shape == (3 * 18, 32)
    with torch.no_grad():
        got = port(torch.from_numpy(clip), torch.from_numpy(mask))
    for a, b in zip(got, (rec, tgt)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy() / np.abs(b).max(), b / np.abs(b).max(), **FWD_TOL)
    stray = {"params": dict(v["params"], extra=np.zeros(3)), "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="extra"):
        token_mae_state_dict_from_flax(stray)
    missing = {"params": {k: v2 for k, v2 in v["params"].items() if k != "mask_token"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="mask_token"):
        token_mae_state_dict_from_flax(missing)


def test_mae_losses_and_statistics_match_jax():
    rng = np.random.default_rng(8)
    pred = rng.standard_normal((B, T * P, 12), dtype=np.float32)
    target = 2.0 * rng.standard_normal((B, T * P, 12), dtype=np.float32) + 0.5
    mask = _token_mask(9)
    args = tuple(torch.from_numpy(a) for a in (pred, target, mask))
    for loss_type in ("l2", "l1", "cosine"):
        for norm in (True, False):
            ref = float(jlosses.build_mae_loss(loss_type, norm)(pred, target, mask))
            got = float(tlosses.build_mae_loss(loss_type, norm)(*args))
            assert got == pytest.approx(ref, rel=1e-5), (loss_type, norm)
    assert float(tlosses.mae_loss_l1(*args)) == pytest.approx(
        float(jlosses.mae_loss_l1(pred, target, mask)), rel=1e-5)
    assert float(tlosses.mae_loss_cosine(*args)) == pytest.approx(
        float(jlosses.mae_loss_cosine(pred, target, mask)), rel=1e-5)
    with pytest.raises(ValueError, match="Unknown mae loss type"):
        tlosses.build_mae_loss("huber")
    ref = jlosses.reconstruction_error_stats(pred, target, mask)
    got = tlosses.reconstruction_error_stats(*args)
    assert set(got) == set(ref) == {"mae_l1", "mae_l2", "pred_std", "target_std"}
    for key in ref:
        assert float(got[key]) == pytest.approx(float(ref[key]), rel=1e-5), key


def test_mask_ratio_schedule_counts_and_modes_match_jax():
    sched = [{"start": 1, "end": 21, "value": 0.7}, {"start": 21, "end": 81, "value": 0.8},
             {"start": 81, "end": 100000, "value": 0.9}]
    for epoch in (0, 1, 20, 21, 80, 81, 100000):
        for s in (sched, None, []):
            assert tmasking.get_mask_ratio(epoch, s, 0.75) == \
                jmasking.get_mask_ratio(epoch, s, 0.75), (epoch, s)
    g = torch.Generator().manual_seed(10)
    for t, p, ratio in ((4, 9, 0.7), (4, 9, 0.9), (3, 4, 0.5), (32, 9, 0.8), (2, 5, 0.01)):
        for mode in ("random", "tube"):
            got = tmasking.make_token_mask(g, 3, t, p, ratio, mode)
            ref = np.asarray(jmasking.make_token_mask(jax.random.key(11), 3, t, p, ratio, mode))
            assert got.shape == ref.shape == (3, t * p) and got.dtype == torch.bool
            assert got.sum(1).tolist() == ref.sum(1).tolist(), (t, p, ratio, mode)
            assert tmasking.count_masked(got) == jmasking.count_masked(ref)
            assert tmasking.count_visible(got) == jmasking.count_visible(ref)
            if mode == "tube":  # the same positions on every frame
                assert (got.reshape(3, t, p) == got.reshape(3, t, p)[:, :1]).all()
    with pytest.raises(ValueError, match="Unknown mask_mode"):
        tmasking.make_token_mask(g, 1, 2, 4, 0.5, "block")
    with pytest.raises(ValueError, match="Unknown mask_mode"):
        teng.make_token_mae_step(None, P, mask_mode="block")
    # the step's traced count: fp32 product, round half to even
    for n, ratio in ((36, 0.7), (9, 0.9), (9, 0.5), (4, 0.625), (10, 0.05)):
        want = int(max(1, jnp.round(n * jnp.float32(ratio))))
        assert teng.traced_mask_count(n, ratio) == want, (n, ratio)


def test_sample_frame_indices_mae_and_dataset_sampling_match_jax(tmp_path):
    for num_frames in (1, 5, 17, 64, 200):
        for clip_len, stride in ((1, 2), (4, 2), (16, 4), (32, 4)):
            for index in (0, 3):
                args = (num_frames, index, clip_len, stride, 42)
                assert tloader.sample_frame_indices_mae(*args) == \
                    jloader.sample_frame_indices_mae(*args), args
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=2,
                                    num_frames=6, image_size=S, seed=0)
    for sampling in ("strided", "mae"):
        kw = dict(clip_len=4, stride=2, image_size=S, seed=3, sampling=sampling, verbose=False)
        got = tloader.ClipDataset(splits["train"], **kw)
        ref = jloader.ClipDataset(splits["train"], **kw)
        for i in range(len(ref)):
            np.testing.assert_array_equal(got.get_clip(i), ref.get_clip(i))


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


_JAX_STEPS = {}  # (mask_mode, loss_type) -> (jitted JAX step, its optimizer)


def _jax_step(mode, loss_type):
    if (mode, loss_type) not in _JAX_STEPS:
        jtx = jeng.wrap_accum_and_skip(jstate.make_optimizer(LR, grad_clip=CLIP, betas=BETAS))
        _JAX_STEPS[mode, loss_type] = (jeng.make_token_mae_step(
            _jax_model(), jtx, tokens_per_frame=P, mask_mode=mode, loss_type=loss_type,
            augment_hflip=True), jtx)
    return _JAX_STEPS[mode, loss_type]


@pytest.mark.parametrize("loss_type", ["l2", "l1", "cosine"])
@pytest.mark.parametrize("ratio", [0.7, 0.9])
@pytest.mark.parametrize("mode", ["tube", "random"])
def test_one_step_matches_make_token_mae_step(variables, mode, ratio, loss_type):
    """One fp32 step with the JAX step's mask and flips: loss, statistics,
    grad_norm and collapse, Adam's moments, new params and BN statistics."""
    clip = np.random.default_rng(12).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    key = jax.random.key(int(ratio * 10) + 100 * len(loss_type) + (mode == "tube"))
    k_mask, _, k_flip = jax.random.split(key, 3)  # as make_token_mae_step splits
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (B, 1, 1, 1, 1))).reshape(B)
    n = T * P if mode == "random" else P
    noise = jax.random.uniform(k_mask, (B, n))
    ranks = jnp.argsort(jnp.argsort(noise, axis=-1, descending=True), axis=-1)
    mask = np.asarray(ranks < jnp.maximum(1, jnp.round(n * jnp.float32(ratio))).astype(jnp.int32))
    if mode == "tube":
        mask = np.tile(mask, (1, T))

    step, jtx = _jax_step(mode, loss_type)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, variables["params"]), jtx,
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             variables["batch_stats"]))
    new, jm = step(jst, {"clip": jnp.asarray(clip)}, key, jnp.float32(ratio))
    bs = jax.tree.map(np.asarray, new.batch_stats)

    def as_port(params):
        return token_mae_state_dict_from_flax({"params": jax.tree.map(np.asarray, params),
                                               "batch_stats": bs})

    adam = _adam_state(new.opt_state)
    ref_grads = {k: v / 0.1 for k, v in as_port(adam.mu).items()}
    ref_nu, ref_new = as_port(adam.nu), as_port(new.params)

    model = _port_model()
    model.load_state_dict(token_mae_state_dict_from_flax(variables))
    tx = teng.wrap_accum_and_skip(tstate.make_optimizer(model.parameters(), LR, grad_clip=CLIP,
                                                        betas=BETAS))
    state = tstate.create_train_state(model, tx)
    port_step = teng.make_token_mae_step(model, P, mask_mode=mode, loss_type=loss_type,
                                         augment_hflip=True)
    state, m = port_step(state, {"clip": torch.from_numpy(clip)},
                         torch.Generator().manual_seed(0), ratio,
                         token_mask=torch.from_numpy(mask), flip=torch.from_numpy(flip))
    assert set(m) == set(jm) == {"loss", "mae_l1", "mae_l2", "pred_std", "target_std",
                                 "grad_norm", "collapse"}
    for name in jm:
        assert float(m[name]) == pytest.approx(float(jm[name]), rel=1e-4), name

    opt = tstate.adamw_of(tx).opt
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    for name, p in model.named_parameters():
        st = opt.state[p]
        np.testing.assert_allclose((st["exp_avg"] / 0.1).numpy(), ref_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * gmax, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), ref_nu[name].numpy(),
                                   rtol=1e-3, atol=1e-8 * gmax ** 2, err_msg=name)
        sure = np.abs(ref_grads[name].numpy()) > 1e-4 * gmax
        np.testing.assert_allclose(p.detach().numpy()[sure], ref_new[name].numpy()[sure],
                                   **NET_TOL, err_msg=name)
    for key_, t in model.state_dict().items():
        if key_.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref_new[key_].numpy(), **NET_TOL, err_msg=key_)


def test_adamw_betas_match_optax_and_round_trip_through_a_state_dict():
    """Three clipped AdamW updates with betas (0.9, 0.95) on a warmup-cosine
    schedule, as optax; the state saved after the second and loaded into a
    fresh optimizer (inside the skip and accumulation wrappers) gives the
    third update bit for bit."""
    rng = np.random.default_rng(13)
    w0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = [rng.standard_normal((3, 5)).astype(np.float32) * s for s in (0.5, 3.0, 1.0)]
    sched = (1e-2, 1, 10, 1e-4)
    jtx = jstate.make_optimizer(jstate.warmup_cosine_schedule(*sched), grad_clip=CLIP,
                                betas=BETAS)
    params, opt_state, ref = {"w": jnp.asarray(w0)}, None, []
    opt_state = jtx.init(params)
    for g in grads:
        updates, opt_state = jtx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        ref.append(np.asarray(params["w"]))

    def make(p):
        return teng.wrap_accum_and_skip(tstate.make_optimizer(
            [p], tstate.warmup_cosine_schedule(*sched), grad_clip=CLIP, betas=BETAS),
            accum_steps=2)

    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tx = make(p)
    got = []
    for g in grads:  # MultiSteps(2): each gradient twice, one update per pair
        for _ in range(2):
            tx.update([torch.from_numpy(g)])
        got.append(p.detach().numpy().copy())
        if len(got) == 2:
            saved = {k: v.clone() for k, v in tx.state_dict().items()}
            saved_p = p.detach().clone()
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    assert tstate.adamw_of(tx).count == 3

    q = torch.nn.Parameter(saved_p)
    tx2 = make(q)
    tx2.load_state_dict(saved)
    for _ in range(2):
        tx2.update([torch.from_numpy(grads[2])])
    assert torch.equal(q.detach(), p.detach())
    assert {k: v.tolist() for k, v in tx2.state_dict().items()} == \
        {k: v.tolist() for k, v in tx.state_dict().items()}


@pytest.fixture
def toy_widths(monkeypatch):
    """The entries build TinyViT-21M at its published widths; the CPU runs
    take the toy ones."""
    monkeypatch.setattr(train_mae, "DEFAULT_EMBED_DIMS", DIMS)


def _entry_cfg(split, out_dir, **training):
    return {"seed": 42, "device": {"name": "cpu", "compute_dtype": "bfloat16"},
            "dataset": {"backend": "packed", "train_split": split, "clip_len": T,
                        "stride": 2, "image_size": S, "augment": True},
            "training": {"epochs": 2, "batch_size": 2, "grad_accum": 3, "clip_grad_norm": 1.0,
                         "lr": 1e-3, "min_lr": 0.0, "weight_decay": 0.05, "betas": [0.9, 0.95],
                         "warmup_epochs": 1, "save_every": 1, "keep_last": 1,
                         "log_interval": 1, **training},
            "output": {"dir": str(out_dir)},
            "mae": {"stage4_pool": 2, "mask_mode": "random", "mask_ratio": 0.8,
                    "mask_ratio_schedule": [{"start": 1, "end": 2, "value": 0.7},
                                            {"start": 2, "end": 100, "value": 0.9}],
                    "loss": {"type": "l2", "normalize_target": True},
                    "decoder": {"dim": 16, "depth": 1, "num_heads": 2, "mlp_ratio": 2.0},
                    "vis_every": 1}}


def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(tmp_path, toy_widths):
    """Two epochs straight against one epoch, a stop, and a resume (two
    steps an epoch under accumulation 3, so the stop falls inside an
    accumulation cycle; flips and stochastic depth on): every param, BN
    statistic and optimizer entry bit-equal, the step count and the
    schedule's count equal, one checkpoint kept, and each epoch's picture
    drawn (``mae.vis_every`` 1: the pictures' forwards leave the training
    state as it was). A changed config resumes
    with a cfg_hash warning, a checkpoint without optimizer state with the
    legacy warning."""
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=3,
                                    num_frames=8, image_size=S, seed=0)
    logs = {"a": [], "b": [], "c": []}
    train_mae.run(_entry_cfg(splits["train"], tmp_path / "a"), log=logs["a"].append)
    cfg_b = _entry_cfg(splits["train"], tmp_path / "b")
    first = train_mae.run(cfg_b, log=logs["b"].append, max_steps=2)
    assert first["steps"] == 2 and os.path.exists(tmp_path / "b" / "ckpt_epoch_1.pt")
    second = train_mae.run(cfg_b, log=logs["b"].append)
    assert second["steps"] == 4 and second["completed"]
    assert any(m.startswith("[INFO] resumed from ") and m.endswith("at epoch 2")
               for m in logs["b"])
    for log in logs.values():
        assert not any(m.startswith("[WARN] vis failed") for m in log)
    for d in ("a", "b"):  # mae.vis_every: 1, a picture each epoch, resumed or not
        assert sorted(os.listdir(tmp_path / d / "vis")) == ["mae_vis_epoch_1.png",
                                                           "mae_vis_epoch_2.png"]
    assert any(" ratio=0.70 " in m for m in logs["a"]) and any(" ratio=0.90 " in m
                                                               for m in logs["a"])

    a = restore_checkpoint(str(tmp_path / "a" / "ckpt_epoch_2"))
    b = restore_checkpoint(str(tmp_path / "b" / "ckpt_epoch_2"))
    assert a["step"] == b["step"] == 4 and a["epoch"] == b["epoch"] == 2
    tensors = [k for k, v in a.items() if isinstance(v, torch.Tensor)]
    assert {"opt.mini_step", "opt.acc.0", "opt.inner.inner.count",
            "opt.inner.inner.0.exp_avg", "mask_token"} <= set(tensors)
    assert int(a["opt.mini_step"]) == 1 and int(a["opt.inner.inner.count"]) == 1
    assert set(tensors) == {k for k, v in b.items() if isinstance(v, torch.Tensor)}
    for k in tensors:
        assert torch.equal(a[k], b[k]), k
    for d in ("a", "b"):  # keep_last: 1
        assert sorted(f for f in os.listdir(tmp_path / d) if f.startswith("ckpt_")) == [
            "ckpt_epoch_2.pt", "ckpt_epoch_2.pt.meta.json"]

    # a changed config, then a legacy checkpoint (no optimizer state)
    cfg_c = _entry_cfg(splits["train"], tmp_path / "b", epochs=3, log_interval=7)
    train_mae.run(cfg_c, log=logs["c"].append)
    assert any("cfg_hash mismatch" in m for m in logs["c"])
    meta_path = tmp_path / "b" / "ckpt_epoch_3.pt.meta.json"
    meta = json.loads(meta_path.read_text())
    meta.pop("has_opt_state")
    meta_path.write_text(json.dumps(meta))
    legacy = []
    out = train_mae.run(dict(cfg_c, training=dict(cfg_c["training"], epochs=4)),
                        log=legacy.append)
    assert out["steps"] == 8 and any("legacy checkpoint" in m for m in legacy)


def test_segment_cap_stops_with_a_checkpoint(tmp_path, toy_widths):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=2,
                                    num_frames=8, image_size=S, seed=0)
    cfg = _entry_cfg(splits["train"], tmp_path / "out", epochs=3, save_every=5,
                     max_epochs_per_run=1, grad_accum=1)
    lines = []
    out = train_mae.run(cfg, log=lines.append)
    assert out == {"best": out["best"], "steps": 1, "completed": False, "stopped_at_epoch": 1}
    assert out["best"]["epoch"] == 1 and np.isfinite(out["best"]["loss"])
    assert os.path.exists(tmp_path / "out" / "ckpt_epoch_1.pt")
    assert any("segment cap" in m for m in lines)
    with open(tmp_path / "out" / "config.json") as f:
        assert json.load(f)["training"]["max_epochs_per_run"] == 1


def test_sanity_check_mae_passes_on_the_cpu(tmp_path, monkeypatch, capsys, toy_widths):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=2,
                                    num_frames=8, image_size=S, seed=0)
    monkeypatch.setattr(sys, "argv", [
        "sanity_check_mae", "--config", str(REPO / "configs" / "mae_train.yaml"),
        "--base", str(REPO / "configs" / "base.yaml"), "--device", "cpu",
        "--set", f"dataset.train_split={splits['train']}", "--set", f"dataset.clip_len={T}",
        "--set", f"dataset.image_size={S}", "--set", "mae.stage4_pool=1"])
    sanity_check_mae.main()
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "[SANITY] PASSED"
    assert any(m.startswith(f"[SANITY] clip (1, {T}, {S}, {S}, 3), mask (1, {T})") for m in out)
    assert any(m.startswith("[SANITY] backward ok: grad_norm=") for m in out)
