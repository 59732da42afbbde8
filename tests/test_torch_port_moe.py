"""The port's MoE decoder (``layers.MoeMlp``, the MoE ``TinyVideoMAE`` and
its pipeline-B step) against the JAX package, in fp32 on the CPU, at toy
widths: tokens of width 8 and 16, 4 experts; the MAE of
``tests/test_torch_port_train_step.py`` (TinyViT dims (8, 16, 24), B=2
clips of T=4 frames at 32x32) with a 2-block MoE decoder 16 wide.

Weights are the JAX package's, moved off their init and carried over by the
converter. Routing is discontinuous, so the inputs are drawn where no token
is near a tie between two experts (the test checks the margin) and both
frameworks route every token alike.

Tolerances: the layer's output and every gradient 1e-5 (rtol, and atol
relative to the largest entry); the step as the dense step's test holds it
(loss and auxiliary 1e-4 relative, gradients 1e-4, new params 1e-5 where the
gradient is not near zero, BN statistics 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_vit_video_analytics_tpu.data.masking import get_tube_mask as jax_tube_mask
from ssl_vit_video_analytics_tpu.models.layers import MoeMlp as JaxMoeMlp
from ssl_vit_video_analytics_tpu.models.mae import TinyVideoMAE as JaxMAE
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.train import mae_engine as jeng
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu_torch.models.layers import MoeMlp, TransformerEncoder
from ssl_vit_video_analytics_tpu_torch.models.mae import TinyVideoMAE
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as tfeng
from ssl_vit_video_analytics_tpu_torch.train import mae_engine as teng
from ssl_vit_video_analytics_tpu_torch.train import state as tstate
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    flatten_variables, mae_state_dict_from_flax, state_dict_from_flax, unflatten_variables)

torch.set_num_threads(2)  # six test workers share the host

D, HID, E = 8, 16, 4
B, T, S = 2, 4, 32
L = (S // 8) ** 2
DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)
MOE = dict(decoder_moe_experts=E, decoder_moe_capacity_factor=1.0, decoder_moe_group_size=16)
TOL = 1e-5
NET_TOL = dict(atol=1e-4, rtol=1e-4)


def _perturb(v, seed, scale=0.1):
    """Every param moved off its init, BN statistics made non-trivial."""
    rng = np.random.default_rng(seed)
    flat = flatten_variables(jax.tree.map(np.asarray, v))
    for key, a in flat.items():
        if key.endswith("/mean"):
            a = 0.3 * rng.standard_normal(a.shape)
        elif key.endswith("/var"):
            a = rng.uniform(0.5, 2.0, a.shape)
        else:
            a = a + scale * rng.standard_normal(a.shape)
        flat[key] = a.astype(np.float32)
    return unflatten_variables(flat)


def _close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


# (tokens B x L, group size, capacity factor): one group; several groups;
# several groups with too few slots, so tokens are dropped
LAYER_CASES = {"one_group": (2, 12, 0, 2.0), "groups": (2, 12, 6, 2.0),
               "drops": (2, 12, 4, 0.5)}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_mlp_output_and_gradients_match_jax(case):
    """Output, aux, and the gradients of sum(y * r) + aux for the input,
    the router and the expert bank; dropped tokens give 0."""
    b, n, group, cf = LAYER_CASES[case]
    jm = JaxMoeMlp(HID, E, cf, group)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, n, D)).astype(np.float32)
    r = rng.standard_normal((b, n, D)).astype(np.float32)
    v = _perturb(jm.init(jax.random.key(2), jnp.asarray(x)), 3, scale=0.5)

    def loss(params, xx):
        y, st = jm.apply({"params": params}, xx, mutable=["intermediates"])
        aux = st["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (y, aux)), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    port = MoeMlp(D, HID, E, cf, group)
    port.load_state_dict(state_dict_from_flax(v, port.state_dict()))
    xt = torch.from_numpy(x).requires_grad_()
    yt, auxt = port(xt)
    aux_t = float(auxt.detach())
    # no token near a tie: both frameworks route alike
    probs = torch.softmax(port.router(xt.detach()), -1).sort(-1).values.detach()
    assert float((probs[..., -1] - probs[..., -2]).min()) > 1e-4
    (torch.sum(yt * torch.from_numpy(r)) + auxt).backward()
    _close(yt.detach().numpy(), y, "y")
    assert aux_t == pytest.approx(float(aux), rel=TOL)
    assert 1.0 / E <= aux_t <= E  # f_e <= E * P_e for the argmax expert
    _close(xt.grad.numpy(), g_x, "x")
    ref = state_dict_from_flax({"params": jax.tree.map(np.asarray, g_params)},
                               port.state_dict())
    assert set(ref) == {"router.weight", "router.bias", "w1", "b1", "w2", "b2"}
    for name, p in port.named_parameters():
        _close(p.grad.numpy(), ref[name].numpy(), name)
    if case == "drops":
        # one slot an expert a group of 4: a token whose expert is taken
        # gives 0 in JAX, and in the port
        assert port.capacity(b * n) == (6, 4, 1)
        dropped = np.abs(np.asarray(y)).sum(-1) == 0
        assert dropped.any() and (yt.detach().numpy()[dropped] == 0).all()
        np.testing.assert_array_equal(port.assignments(xt).numpy() == -1, dropped.reshape(-1))


def test_moe_group_size_must_divide_the_tokens():
    port = MoeMlp(D, HID, E, group_size=5)
    with pytest.raises(ValueError, match="must divide the token count"):
        port(torch.zeros(2, 12, D))
    assert port.capacity(10) == (2, 5, 3)  # ceil(5 * 2.0 / 4)
    assert MoeMlp(384, 1536, 8, 1.25, 392).capacity(2 * 3136) == (16, 392, 62)


def test_moe_encoder_returns_each_blocks_aux_and_dense_none():
    enc = TransformerEncoder(D, 2, 2, moe_experts=E)
    x = torch.randn(2, 6, D)
    y, auxes = enc(x, with_aux=True)
    assert len(auxes) == 2 and all(a.dim() == 0 for a in auxes)
    torch.testing.assert_close(enc(x), y, atol=0, rtol=0)
    dense = TransformerEncoder(D, 2, 2)
    assert dense(x, with_aux=True)[1] == []


# --- the MoE TinyVideoMAE and its pipeline-B step ---

def _jax_mae():
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS,
                     use_checkpoint=False, drop_path_rate=0.0)
    return JaxMAE(encoder=enc, clip_len=T, img_size=S, patch_size=8, decoder_embed_dim=16,
                  decoder_depth=2, decoder_num_heads=2, **MOE)


def _port_mae(**moe):
    enc = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                  use_checkpoint=True, num_stages=3)
    return TinyVideoMAE(enc, clip_len=T, img_size=S, decoder_embed_dim=16, decoder_depth=2,
                        decoder_num_heads=2, **moe)


@pytest.fixture(scope="module")
def moe_variables():
    model = _jax_mae()
    v = jax.jit(lambda k: model.init(k, jnp.zeros((B, T, S, S, 3)),
                                     jnp.zeros((B, T, L), bool)))(jax.random.key(0))
    return _perturb(v, 1)


def test_converter_round_trips_a_moe_mae_and_refuses_strays(moe_variables):
    sd = mae_state_dict_from_flax(moe_variables)
    port = _port_mae(**MOE)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    bank = moe_variables["params"]["decoder"]["block1"]["MoeMlp_0"]
    np.testing.assert_array_equal(port.decoder.blocks[1].mlp.w2.detach().numpy(), bank["w2"])
    np.testing.assert_array_equal(port.decoder.blocks[1].mlp.router.weight.detach().numpy(),
                                  bank["router"]["kernel"].T)
    extra = unflatten_variables(dict(flatten_variables(moe_variables),
                                     **{"params/decoder/block0/MoeMlp_0/w3": np.zeros(3)}))
    with pytest.raises(KeyError, match="w3"):
        mae_state_dict_from_flax(extra)
    flat = flatten_variables(moe_variables)
    del flat["params/decoder/block0/MoeMlp_0/b1"]
    with pytest.raises(KeyError, match="decoder.blocks.0.mlp.b1"):
        mae_state_dict_from_flax(unflatten_variables(flat))


def _clip_u8(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)


def _jax_mask(rng_key):
    k_mask, _ = jax.random.split(rng_key)  # as make_pixel_mae_step splits its key
    return np.array(jax_tube_mask(k_mask, B, T, L, 0.75))


def test_moe_step_matches_make_pixel_mae_step(moe_variables):
    """One fp32 step with moe_aux_weight 0.01 and the JAX mask: loss,
    moe_aux, gradients (Adam's first moment over 1 - b1), the second
    moment, new params and BN statistics."""
    clip = _clip_u8(13)
    key = jax.random.key(14)
    jtx = jeng.wrap_accum_and_skip(jstate.make_optimizer(1e-3), accum_steps=1)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, moe_variables["params"]), jtx,
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             moe_variables["batch_stats"]))
    new_jst, jm = jeng.make_pixel_mae_step(_jax_mae(), jtx, mask_ratio=0.75,
                                           moe_aux_weight=0.01)(
        jst, {"clip": jnp.asarray(clip)}, key)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_jst.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    as_port = lambda params: mae_state_dict_from_flax(  # noqa: E731
        {"params": jax.tree.map(np.asarray, params), "batch_stats": new_jst.batch_stats})
    ref_grads = {k: v / 0.1 for k, v in as_port(adam.mu).items()}
    ref_nu, ref_new = as_port(adam.nu), as_port(new_jst.params)

    port = _port_mae(**MOE)
    port.load_state_dict(mae_state_dict_from_flax(moe_variables))
    tx = teng.wrap_accum_and_skip(tstate.make_optimizer(port.parameters(), 1e-3), 1)
    state = tstate.create_train_state(port, tx)
    step = teng.make_pixel_mae_step(port, mask_ratio=0.75, moe_aux_weight=0.01)
    state, m = step(state, {"clip": torch.from_numpy(clip)}, torch.Generator().manual_seed(0),
                    mask=torch.from_numpy(_jax_mask(key)))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(m["moe_aux"]) == pytest.approx(float(jm["moe_aux"]), rel=1e-4)
    assert 1.0 / E <= float(m["moe_aux"]) <= E
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    opt = tstate.adamw_of(tx).opt
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    named = dict(port.named_parameters())
    assert any(".mlp.w1" in n for n in named) and any(".mlp.router." in n for n in named)
    for name, p in named.items():
        st = opt.state[p]
        g = (st["exp_avg"] / 0.1).numpy()
        np.testing.assert_allclose(g, ref_grads[name].numpy(), rtol=1e-4, atol=1e-4 * gmax,
                                   err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), ref_nu[name].numpy(),
                                   rtol=1e-3, atol=1e-8 * gmax ** 2, err_msg=name)
        sure = np.abs(ref_grads[name].numpy()) > 1e-4 * gmax
        np.testing.assert_allclose(p.detach().numpy()[sure], ref_new[name].numpy()[sure],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for k, t in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref_new[k].numpy(), **NET_TOL, err_msg=k)


def test_dense_step_is_unchanged_by_the_aux_weight():
    """The dense decoder takes the plain step whatever moe_aux_weight says:
    bit-equal params after a step, no moe_aux metric."""
    clip = torch.from_numpy(_clip_u8(15))
    mask = torch.from_numpy(_jax_mask(jax.random.key(16)))
    torch.manual_seed(17)
    start = _port_mae().state_dict()
    results = []
    for weight in (0.0, 0.01):
        port = _port_mae()
        port.load_state_dict(start)
        tx = teng.wrap_accum_and_skip(tstate.make_optimizer(port.parameters(), 1e-3), 1)
        state, m = teng.make_pixel_mae_step(port, mask_ratio=0.75, moe_aux_weight=weight)(
            tstate.create_train_state(port, tx), {"clip": clip},
            torch.Generator().manual_seed(0), mask=mask)
        assert "moe_aux" not in m
        results.append((float(m["loss"]), port.state_dict()))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], v, atol=0, rtol=0, msg=k)


def test_init_model_gives_the_bank_flax_fan_in_scaling():
    port = _port_mae(decoder_moe_experts=8, decoder_moe_capacity_factor=1.25,
                     decoder_moe_group_size=16)
    port.decoder.blocks[0].mlp.w1.data.fill_(5.0)
    tfeng.init_model(port, torch.Generator().manual_seed(0))
    moe = port.decoder.blocks[0].mlp
    for w, fan_in in ((moe.w1, 16), (moe.w2, 64)):
        std = float(w.detach().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.15, (std, fan_in)
        # truncated at 2 standard deviations of the untruncated normal
        assert float(w.detach().abs().max()) <= 2.0 / 0.87962566103423978 / fan_in ** 0.5
    assert not moe.b1.detach().any() and not moe.router.bias.detach().any()
