"""The port's pipeline-B pretraining slice against the JAX package, in fp32
on the CPU, at toy widths: TinyViT dims (8, 16, 24), depths (1, 1, 1), heads
(1, 2, 2); decoder 16 wide, 1 block, 2 heads; B=2 clips of T=4 frames at
32x32.

Weights are the JAX package's, carried over by ``mae_state_dict_from_flax``
after every param is perturbed away from its init and the BatchNorm
statistics made non-trivial, so a swapped or dropped tensor shows. Random
streams differ across frameworks, so the JAX tube mask is injected and
stochastic depth is off (rate 0) where values are compared.

Tolerances: 1e-5 for single layers; 1e-4 (rtol and, for gradients, atol
relative to the largest entry) for the model and the step, ~20 fp32 layers
summed in other orders by XLA and by PyTorch's CPU kernels; patchify is
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_vit_video_analytics_tpu.data.masking import get_tube_mask as jax_tube_mask
from ssl_vit_video_analytics_tpu.models import layers as jl
from ssl_vit_video_analytics_tpu.models.mae import TinyVideoMAE as JaxMAE
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.ops.patchify import (
    masked_mse as jax_masked_mse, normalize_pix_target as jax_normalize_pix_target,
    patchify as jax_patchify)
from ssl_vit_video_analytics_tpu.train import losses as jlosses
from ssl_vit_video_analytics_tpu.train import mae_engine as jeng
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu.utils import metrics as jmetrics
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.data.masking import get_tube_mask
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.models import layers as tl
from ssl_vit_video_analytics_tpu_torch.models.mae import TinyVideoMAE
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
from ssl_vit_video_analytics_tpu_torch.ops import patchify as tpatch
from ssl_vit_video_analytics_tpu_torch.train import losses as tlosses
from ssl_vit_video_analytics_tpu_torch.train import mae_engine as teng
from ssl_vit_video_analytics_tpu_torch.train import state as tstate
from ssl_vit_video_analytics_tpu_torch.utils import metrics as tmetrics
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    flatten_variables, mae_state_dict_from_flax, state_dict_from_flax, unflatten_variables)

torch.set_num_threads(2)  # six test workers share the host

B, T, S = 2, 4, 32
L = (S // 8) ** 2
DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)
TOL = dict(atol=1e-5, rtol=1e-5)
NET_TOL = dict(atol=1e-4, rtol=1e-4)


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


def _jax_mae():
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS,
                     use_checkpoint=False, drop_path_rate=0.0)
    return JaxMAE(encoder=enc, clip_len=T, img_size=S, patch_size=8,
                  decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)


def _port_mae(use_checkpoint=True, drop_path_rate=0.0):
    enc = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS,
                  drop_path_rate=drop_path_rate, use_checkpoint=use_checkpoint, num_stages=3)
    return TinyVideoMAE(enc, clip_len=T, img_size=S, decoder_embed_dim=16,
                        decoder_depth=1, decoder_num_heads=2)


@pytest.fixture(scope="module")
def mae_variables():
    model = _jax_mae()
    v = jax.jit(lambda k: model.init(k, jnp.zeros((B, T, S, S, 3)),
                                     jnp.zeros((B, T, L), bool)))(jax.random.key(0))
    return _perturb(v, 1)


def _clip_u8(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)


def _jax_mask(rng_key):
    k_mask, _ = jax.random.split(rng_key)  # as make_pixel_mae_step splits its key
    return np.asarray(jax_tube_mask(k_mask, B, T, L, 0.75))


def test_patchify_roundtrip_is_exact_and_token_order_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 24, 3), dtype=np.float32)
    tokens = tpatch.patchify(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jax_patchify(x, 8)))
    back = tpatch.unpatchify(tokens, 8, 3, 16, 24)
    np.testing.assert_array_equal(back.numpy(), x)
    t = np.asarray(jax_patchify(x, 8))
    np.testing.assert_allclose(tpatch.normalize_pix_target(torch.from_numpy(t)).numpy(),
                               np.asarray(jax_normalize_pix_target(t)), **TOL)


def test_tube_mask_counts_and_broadcast():
    g = torch.Generator().manual_seed(3)
    mask = get_tube_mask(g, 5, 16, 196, 0.9)
    assert mask.shape == (5, 16, 196) and mask.dtype == torch.bool
    assert (mask.sum(-1) == 176).all()  # int(0.9 * 196): floor, not round
    assert (mask == mask[:, :1]).all()  # the same patches on every frame
    assert not (mask[0] == mask[1]).all()
    assert get_tube_mask(torch.Generator().manual_seed(3), 5, 16, 196, 0.9).equal(mask)


@pytest.mark.parametrize("name,jax_module,port_module,shape", [
    ("stem_s2", jl.ConvBNAct(8, kernel=3, stride=2, act=False),
     tl.ConvBNAct(3, 8, kernel=3, stride=2, act=False), (3, 8, 8, 3)),
    ("mbconv_res", jl.MBConv(8), tl.MBConv(8, 8), (3, 6, 6, 8)),
    ("mbconv_down", jl.MBConv(12, stride=2), tl.MBConv(8, 12, stride=2), (3, 6, 6, 8)),
])
def test_train_mode_conv_blocks_match_flax(name, jax_module, port_module, shape):
    """Batch statistics in the forward; running mean and BIASED variance
    moved 0.1 of the way to them."""
    x = np.random.default_rng(4).standard_normal(shape, dtype=np.float32) + 0.5
    v = _perturb(jax_module.init(jax.random.key(5), jnp.asarray(x)), 6)
    ref, mutated = jax_module.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port_module.load_state_dict(state_dict_from_flax(v, port_module.state_dict()))
    port_module.train()
    out = port_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref), **TOL)
    new = state_dict_from_flax({"params": v["params"], "batch_stats": mutated["batch_stats"]},
                               port_module.state_dict())
    for key, t in port_module.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), new[key].numpy(), **TOL, err_msg=key)


def test_forward_stage3_train_mode_matches_jax(mae_variables):
    enc_vars = {c: mae_variables[c]["encoder"] for c in ("params", "batch_stats")}
    x = np.random.default_rng(7).standard_normal((B * T, S, S, 3), dtype=np.float32)
    jax_enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS,
                         use_checkpoint=False, drop_path_rate=0.0)
    ref, mutated = jax.jit(lambda v, a: jax_enc.apply(
        v, a, train=True, stage_limit=3, mutable=["batch_stats"]))(enc_vars, jnp.asarray(x))
    port = _port_mae()
    port.load_state_dict(mae_state_dict_from_flax(mae_variables))
    enc = port.encoder.train()
    out = enc.forward_stage3(torch.from_numpy(x))
    assert out.shape == (B * T, S // 8, S // 8, DIMS[2])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **NET_TOL)
    new = mae_state_dict_from_flax({
        "params": mae_variables["params"],
        "batch_stats": dict(mae_variables["batch_stats"], encoder=mutated["batch_stats"])})
    for key, t in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), new[key].numpy(), **NET_TOL, err_msg=key)


def test_tiny_video_mae_eval_matches_jax_with_the_same_mask(mae_variables):
    clip = np.random.default_rng(8).standard_normal((B, T, S, S, 3), dtype=np.float32)
    mask = _jax_mask(jax.random.key(9))
    ref = np.asarray(jax.jit(_jax_mae().apply)(mae_variables, jnp.asarray(clip),
                                               jnp.asarray(mask)))
    port = _port_mae()
    port.load_state_dict(mae_state_dict_from_flax(mae_variables))
    with torch.no_grad():
        pred = port.eval()(torch.from_numpy(clip), torch.from_numpy(mask.copy()))
    assert pred.shape == (B, T * L, 8 * 8 * 3)
    np.testing.assert_allclose(pred.numpy(), ref, **NET_TOL)


def test_mae_loss_l2_matches_jax():
    rng = np.random.default_rng(10)
    pred = rng.standard_normal((B, T * L, 192), dtype=np.float32)
    target = 3.0 * rng.standard_normal((B, T * L, 192), dtype=np.float32) + 1.0
    mask = _jax_mask(jax.random.key(11)).reshape(B, T * L)
    for norm in (True, False):
        ref = float(jlosses.mae_loss_l2(pred, target, mask, normalize_target=norm))
        got = float(tlosses.mae_loss_l2(*(torch.from_numpy(x) for x in (pred, target, mask)),
                                        normalize_target=norm))
        assert got == pytest.approx(ref, rel=1e-5)
    got = float(tpatch.masked_mse(*(torch.from_numpy(x) for x in (pred, target, mask))))
    assert got == pytest.approx(float(jax_masked_mse(pred, target, mask)), rel=1e-5)


def test_pipeline_b_flops_accounting_matches_jax():
    cfg = {"model": {"embed_dims": [64, 128, 256, 576], "decoder_embed_dim": 192,
                     "decoder_depth": 2}}
    for c in ({}, cfg):
        kw = tmetrics.pipeline_b_model_kwargs(c)
        assert kw == jmetrics.pipeline_b_model_kwargs(c)
        assert tmetrics.pipeline_b_flops_per_clip(16, 112, **kw) == \
            jmetrics.pipeline_b_flops_per_clip(16, 112, **kw)


def test_warmup_cosine_schedule_matches_optax():
    for args in ((5e-4, 40, 200, 1e-6), (1e-3, 0, 10, 0.0), (1e-3, 10, 5, 1e-5)):
        ref = jstate.warmup_cosine_schedule(*args)
        got = tstate.warmup_cosine_schedule(*args)
        for count in (0, 1, 2, 9, 10, 39, 40, 41, 100, 199, 200, 250):
            assert got(count) == pytest.approx(float(ref(count)), rel=1e-5, abs=1e-12), (args, count)


def _optax_run(grads_seq, tx, params):
    state = tx.init(params)
    out = []
    for g in grads_seq:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        out.append(np.asarray(params["w"]))
    return out


def _port_run(grads_seq, tx, p):
    out = []
    for g in grads_seq:
        tx.update([torch.from_numpy(g["w"])])
        out.append(p.detach().numpy().copy())
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_skip_and_multisteps_match_optax(accum):
    """Identical gradients through optax and the port: warm-up lr (0 on the
    first update), decay on every param, a non-finite gradient skipped
    without advancing the count, and MultiSteps(2) updating on every
    second call with the mean gradient."""
    rng = np.random.default_rng(12)
    w0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = [{"w": rng.standard_normal((3, 5)).astype(np.float32)} for _ in range(8)]
    # accum 1: the third update is skipped; accum 2: a whole finite cycle
    # around it, since optax's accumulator keeps a NaN once it has one
    bad = 2 if accum == 1 else 6
    grads[bad]["w"][1, 2] = np.inf
    sched_args = (1e-2, 2, 10, 1e-4)
    ref_tx = jeng.wrap_accum_and_skip(
        jstate.make_optimizer(jstate.warmup_cosine_schedule(*sched_args)), accum_steps=accum)
    n = len(grads) if accum == 1 else bad  # optax past a NaN cycle never updates again
    ref = _optax_run(grads[:n], ref_tx, {"w": jnp.asarray(w0)})
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tx = teng.wrap_accum_and_skip(
        tstate.make_optimizer([p], tstate.warmup_cosine_schedule(*sched_args)), accum_steps=accum)
    got = _port_run(grads, tx, p)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5, err_msg=f"call {i}")
    if accum == 1:
        np.testing.assert_array_equal(got[bad], got[bad - 1])  # skipped
        assert tstate.adamw_of(tx).count == len(grads) - 1
    else:
        # params may move on calls 2, 4, ... only; the first update's lr is 0
        np.testing.assert_array_equal(got[0], w0)
        np.testing.assert_array_equal(got[1], w0)
        np.testing.assert_array_equal(got[2], got[1])
        assert not np.array_equal(got[3], got[2])
        np.testing.assert_array_equal(got[7], got[5])       # the non-finite cycle is skipped
        assert tstate.adamw_of(tx).count == 3
        assert tx.inner.total_notfinite == 1


def test_one_step_matches_make_pixel_mae_step(mae_variables):
    """One fp32 step with the JAX mask: loss, gradients (Adam's first moment
    over 1 - b1), the second moment, new params where the gradient is not
    near zero (Adam's first step is about lr * sign(g)), and BN statistics."""
    clip = _clip_u8(13)
    key = jax.random.key(14)
    model = _jax_mae()
    jtx = jeng.wrap_accum_and_skip(jstate.make_optimizer(1e-3), accum_steps=1)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, mae_variables["params"]), jtx,
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             mae_variables["batch_stats"]))
    new_jst, jm = jeng.make_pixel_mae_step(model, jtx, mask_ratio=0.75)(
        jst, {"clip": jnp.asarray(clip)}, key)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_jst.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    as_port = lambda params: mae_state_dict_from_flax(  # noqa: E731
        {"params": jax.tree.map(np.asarray, params), "batch_stats": new_jst.batch_stats})
    ref_grads = {k: v / 0.1 for k, v in as_port(adam.mu).items()}
    ref_nu = as_port(adam.nu)
    ref_new = as_port(new_jst.params)

    port = _port_mae(use_checkpoint=True)
    port.load_state_dict(mae_state_dict_from_flax(mae_variables))
    tx = teng.wrap_accum_and_skip(tstate.make_optimizer(port.parameters(), 1e-3), 1)
    state = tstate.create_train_state(port, tx)
    step = teng.make_pixel_mae_step(port, mask_ratio=0.75)
    state, m = step(state, {"clip": torch.from_numpy(clip)}, torch.Generator().manual_seed(0),
                    mask=torch.from_numpy(_jax_mask(key)))
    assert state.step == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert float(m["pred_std"]) == pytest.approx(float(jm["pred_std"]), rel=1e-4)
    opt = tstate.adamw_of(tx).opt
    names = dict(port.named_parameters())
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    for name, p in names.items():
        st = opt.state[p]
        g = (st["exp_avg"] / 0.1).numpy()
        np.testing.assert_allclose(g, ref_grads[name].numpy(), rtol=1e-4, atol=1e-4 * gmax,
                                   err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), ref_nu[name].numpy(),
                                   rtol=1e-3, atol=1e-8 * gmax ** 2, err_msg=name)
        sure = np.abs(ref_grads[name].numpy()) > 1e-4 * gmax
        np.testing.assert_allclose(p.detach().numpy()[sure], ref_new[name].numpy()[sure],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for key_, t in port.state_dict().items():
        if key_.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref_new[key_].numpy(), **NET_TOL, err_msg=key_)


def test_remat_gives_the_same_grads_and_running_stats():
    """Activation checkpointing per stage: the recompute sees the same
    stochastic-depth decisions and updates no BN statistics twice."""
    torch.manual_seed(15)
    ref_model = _port_mae(use_checkpoint=False, drop_path_rate=0.5)
    remat_model = _port_mae(use_checkpoint=True, drop_path_rate=0.5)
    remat_model.load_state_dict(ref_model.state_dict())
    clip = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (B, T, S, S, 3), dtype=np.float32))
    mask = get_tube_mask(torch.Generator().manual_seed(17), B, T, L, 0.75)
    drop = ref_model.draw_drop_path(B, T, torch.Generator().manual_seed(18))
    assert any(k is not None for stage in drop for k in stage)
    grads = []
    for model in (ref_model, remat_model):
        model.train()
        loss = model(clip, mask, drop).square().mean()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    for (k, a), b in zip(ref_model.state_dict().items(), remat_model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=k)
    with pytest.raises(ValueError, match="needs its decisions"):
        ref_model(clip, mask)


def test_converter_covers_the_mae_and_refuses_strays(mae_variables):
    sd = mae_state_dict_from_flax(mae_variables)
    assert {"temporal_pos_embed", "spatial_pos_embed", "mask_token",
            "encoder.patch_embed.conv1.conv.weight", "encoder.stages.1.down.se.fc1.weight",
            "encoder.stages.0.mbconvs.0.project.bn.running_var",
            "decoder.blocks.0.attn.qkv.weight", "decoder_pred.weight"} <= set(sd)
    stray = {"params": dict(mae_variables["params"], extra_embed=np.zeros(3)),
             "batch_stats": mae_variables["batch_stats"]}
    with pytest.raises(KeyError, match="extra_embed"):
        mae_state_dict_from_flax(stray)


def test_entry_trains_at_toy_size_on_the_cpu(tmp_path):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=2,
                                    num_frames=12, image_size=32, seed=0)
    cfg = {"seed": 0, "device": {"name": "cpu", "compute_dtype": "bfloat16"},
           "dataset": {"train_split": splits["train"], "clip_len": 4, "stride": 2,
                       "image_size": 32, "backend": "packed"},
           "model": {"embed_dims": [24, 48, 96, 576], "decoder_embed_dim": 16,
                     "decoder_depth": 1, "decoder_num_heads": 2},
           "ssl": {"mask_ratio": 0.9, "norm_pix_loss": True},
           "training": {"epochs": 1, "batch_size": 2, "accumulation_steps": 2, "lr": 1e-3,
                        "warmup_epochs": 0, "save_dir": str(tmp_path / "out"),
                        "log_interval": 1, "save_full": True}}
    lines, seen = [], []
    out = train_ssl_mae.run(cfg, log=lines.append,
                            on_step=lambda i, st, m: seen.append((i, st.step)))
    assert out["steps"] == seen[-1][0] == seen[-1][1] >= 1
    assert np.isfinite(out["last_loss"])
    assert any(ln.startswith("[INFO] ep=1 step=1/") and " gnorm=" in ln and " clips/s=" in ln
               and " eta=" in ln for ln in lines)
    assert (tmp_path / "out" / "ckpt_epoch_1.pt").exists()
    full = torch.load(tmp_path / "out" / "ckpt_full_epoch_1.pt", weights_only=True)
    assert "mask_token" in full and all(
        k.startswith("encoder.") for k in torch.load(tmp_path / "out" / "ckpt_epoch_1.pt",
                                                     weights_only=True))
    # a multi-device knob is resolved as the JAX entry resolves it on one
    # device: warned about and ignored
    lines = []
    out = train_ssl_mae.run(dict(cfg, device={"name": "cpu", "pipeline_parallel": 2}),
                            log=lines.append, max_steps=1)
    assert out["steps"] == 1 and np.isfinite(out["last_loss"])
    assert "[WARN] pipeline_parallel requested on 1 device; ignoring" in lines



TRAJECTORY_STEPS, TRAJECTORY_LR = 4, 1e-3


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def test_trajectory_matches_make_pixel_mae_step(mae_variables):
    """TRAJECTORY_STEPS fp32 steps from the same weights, each with its own
    clip and the JAX step's mask (stochastic depth off).

    AdamW moves an entry by about lr * sign(g) on its first steps, so where
    g is rounding noise (a gradient that is zero in exact arithmetic) the
    two runs move it by up to 2 * lr apart a step: sign noise. At lr
    TRAJECTORY_LR it does not decide the result: the losses agree to 7e-7
    relative over the 4 steps (measured), gradient norm and pred_std to
    3e-6. So, after each step: the loss, gradient norm and pred_std to 2e-5
    relative; every param within 2 * lr * (steps so far) of JAX's (the sign
    noise bound; measured up to 1.2 * lr a step); on the entries whose
    gradient exceeded 1e-3 of the largest at every step so far (half of
    them by step 4), the update from the initial params to 5e-2 relative
    (measured 1.1e-2: Adam's second moment still holds the early steps'
    small gradients); the BN statistics after the first step to 1e-4 of
    each leaf's largest entry, after step t + 1 to 2e-3 * t of it (the
    batch statistics of params that sign noise moved apart: measured
    8e-4, 2.1e-3, 3.7e-3)."""
    model = _jax_mae()
    jtx = jeng.wrap_accum_and_skip(jstate.make_optimizer(TRAJECTORY_LR), accum_steps=1)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, mae_variables["params"]), jtx,
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             mae_variables["batch_stats"]))
    jstep = jeng.make_pixel_mae_step(model, jtx, mask_ratio=0.75)
    port = _port_mae(use_checkpoint=True)
    port.load_state_dict(mae_state_dict_from_flax(mae_variables))
    tx = teng.wrap_accum_and_skip(tstate.make_optimizer(port.parameters(), TRAJECTORY_LR), 1)
    state = tstate.create_train_state(port, tx)
    step = teng.make_pixel_mae_step(port, mask_ratio=0.75)
    names = dict(port.named_parameters())
    start = {k: p.detach().numpy().copy() for k, p in names.items()}
    sure, mu_prev = None, None
    for t in range(TRAJECTORY_STEPS):
        clip, key = _clip_u8(40 + t), jax.random.key(50 + t)
        jst, jm = jstep(jst, {"clip": jnp.asarray(clip)}, key)
        state, m = step(state, {"clip": torch.from_numpy(clip)},
                        torch.Generator().manual_seed(t),
                        mask=torch.from_numpy(np.array(_jax_mask(key))))
        for k in ("loss", "grad_norm", "pred_std"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=2e-5), (t, k)
        as_port = lambda tree: {k: v.numpy() for k, v in mae_state_dict_from_flax(  # noqa: E731
            {"params": jax.tree.map(np.asarray, tree), "batch_stats": jst.batch_stats}).items()}
        ref = as_port(jst.params)
        # JAX's gradient of this step, from Adam's first moment (b1 0.9)
        mu = as_port(_adam_state(jst.opt_state).mu)
        grads = {k: (mu[k] - (0.9 * mu_prev[k] if mu_prev else 0.0)) / 0.1 for k in names}
        mu_prev = mu
        gmax = max(float(np.abs(g).max()) for g in grads.values())
        now = {k: np.abs(g) > 1e-3 * gmax for k, g in grads.items()}
        sure = now if sure is None else {k: sure[k] & now[k] for k in names}
        for name, p in names.items():
            got, want = p.detach().numpy(), ref[name]
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * TRAJECTORY_LR * (t + 1),
                                       err_msg=f"step {t} {name}")
            np.testing.assert_allclose((got - start[name])[sure[name]],
                                       (want - start[name])[sure[name]], rtol=5e-2, atol=1e-7,
                                       err_msg=f"step {t} {name}")
        for key_, v in port.state_dict().items():
            if key_.endswith(("running_mean", "running_var")):
                drift = 1e-4 if t == 0 else 2e-3 * t
                np.testing.assert_allclose(v.numpy(), ref[key_], rtol=0,
                                           atol=drift * np.abs(ref[key_]).max(),
                                           err_msg=f"step {t} {key_}")
    assert state.step == TRAJECTORY_STEPS
