"""The port's on-device finetune augmentation (``ops/augment.py``) and the
augmented finetune step against the JAX package, in fp32 on the CPU.

Random streams differ across frameworks, so the tests reproduce JAX's draws
from ``jax.random`` as its ``augment_clip`` splits and draws them
(``ops/augment.py:29-55``) and hand them to the port. The augmented clip is
held to 1e-6; the step (a toy TinyViT classifier: dims (8, 16, 24), depths
(1, 1, 1), no stochastic depth, B=2 clips of T=4 frames at 32x32) to
``tests/test_torch_port_finetune.py``'s tolerances: loss 1e-4, gradients
1e-4 (of the largest in absolute terms), BN statistics 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ssl_vit_video_analytics_tpu.models.classifier import VideoClassifier as JaxClassifier
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.ops import augment as jaug
from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu_torch.models.classifier import VideoClassifier
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT, TinyViTBackbone
from ssl_vit_video_analytics_tpu_torch.ops import augment as taug
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as teng
from ssl_vit_video_analytics_tpu_torch.train import state as tstate
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    classifier_state_dict_from_flax, flatten_variables, unflatten_variables)
from ssl_vit_video_analytics_tpu_torch.utils.prng import step_generator

torch.set_num_threads(2)  # six test workers share the host

B, T, S, C = 2, 4, 32, 4
DIMS = (8, 16, 24, 32)
SEED = 5
AUG_TOL = dict(atol=1e-6, rtol=1e-6)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
SETTINGS = {
    "defaults": {},
    "all_on": {"max_shift": 3, "brightness": 0.4, "contrast": 0.3, "hflip": True},
    "photometric_only": {"max_shift": 0, "brightness": 0.2, "contrast": 0.0, "hflip": True},
}


def jax_draws(key, batch: int, max_shift=8, brightness=0.2, contrast=0.2,
              hflip=False) -> taug.AugmentDraws:
    """The draws of JAX's ``augment_clip(key, ...)`` in fp32, as the port
    takes them (a field None where its augmentation is off)."""
    k_shift, k_bri, k_con, k_flip = jax.random.split(key, 4)
    as_t = lambda a: torch.from_numpy(np.array(a).reshape(batch, -1).squeeze(-1))  # noqa: E731
    one = (batch, 1, 1, 1, 1)
    return taug.AugmentDraws(
        offsets=(torch.from_numpy(np.array(jax.random.randint(
            k_shift, (batch, 2), 0, 2 * max_shift + 1))) if max_shift > 0 else None),
        delta=(as_t(jax.random.uniform(k_bri, one, jnp.float32, -brightness, brightness))
               if brightness > 0 else None),
        gain=(as_t(jax.random.uniform(k_con, one, jnp.float32, 1 - contrast, 1 + contrast))
              if contrast > 0 else None),
        flip=as_t(jax.random.bernoulli(k_flip, 0.5, one)) if hflip else None)


def _clip_u8(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_augment_clip_matches_jax_with_jax_draws(setting):
    kw = SETTINGS[setting]
    clip = np.random.default_rng(0).standard_normal((3, T, 20, 24, 3)).astype(np.float32)
    for k in range(4):  # several keys: shifts, flips and both signs of the jitter
        key = jax.random.key(k)
        ref = np.asarray(jaug.augment_clip(key, jnp.asarray(clip), **kw))
        got = taug.augment_clip(torch.from_numpy(clip), draws=jax_draws(key, 3, **kw), **kw)
        assert got.shape == clip.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **AUG_TOL, err_msg=f"{setting} key {k}")


def test_augment_draws_come_from_the_generator_and_stay_in_range():
    kw = {"max_shift": 2, "brightness": 0.2, "contrast": 0.3, "hflip": True}
    draws = taug.draw_augment(torch.Generator().manual_seed(1), 64, **kw)
    assert draws.offsets.shape == (64, 2) and int(draws.offsets.min()) >= 0
    assert int(draws.offsets.max()) == 4 and int(draws.offsets.min()) == 0
    assert float(draws.delta.abs().max()) <= 0.2
    assert float((draws.gain - 1).abs().max()) <= 0.3
    assert 0 < int(draws.flip.sum()) < 64
    clip = torch.randn(64, 2, 6, 6, 3)
    again = taug.augment_clip(clip, torch.Generator().manual_seed(1), **kw)
    torch.testing.assert_close(taug.augment_clip(clip, draws=draws, **kw), again,
                               atol=0, rtol=0)
    # a zero shift with no jitter is the identity
    torch.testing.assert_close(
        taug.augment_clip(clip, torch.Generator(), max_shift=0, brightness=0, contrast=0),
        clip, atol=0, rtol=0)


def test_augment_from_cfg_matches_jax():
    assert taug.augment_from_cfg({}) is None and jaug.augment_from_cfg({}) is None
    assert taug.augment_from_cfg({"augment": False}) is None
    on = taug.augment_from_cfg({"augment": True})
    assert on.func is taug.augment_clip and on.keywords == jaug.augment_from_cfg(
        {"augment": True}).keywords == {}
    mapped = {"augment": {"max_shift": 4, "hflip": True}}
    assert taug.augment_from_cfg(mapped).keywords == jaug.augment_from_cfg(mapped).keywords


# --- the augmented finetune step, against make_train_step(augment=...) ---

class _StepBackbone(fnn.Module):
    """TinyViTBackbone's tree (``encoder``, stage limit 3) with depths
    (1, 1, 1) and no stochastic depth, for comparable train steps."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        feat = JaxTinyViT(embed_dims=DIMS, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                          drop_path_rate=0.0, use_checkpoint=False, name="encoder")(
            x, train=train, stage_limit=3)
        return feat, jnp.mean(feat, axis=(1, 2))


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


def test_augmented_finetune_step_matches_jax():
    """One ft_random step with training.augment (shift 4, both jitters,
    flip): JAX draws from fold_in(key(seed + 1), step 0); the port's step
    augments after normalize_clip with the same draws. Loss, the gradient
    Adam saw, new params, BN statistics; and the augmentation changed the
    step."""
    kw = {"max_shift": 4, "brightness": 0.2, "contrast": 0.2, "hflip": True}
    jmodel = JaxClassifier(backbone=_StepBackbone(), num_classes=C)
    v = _perturb(jeng.init_model(jmodel, jax.random.key(3), (B, T, S, S, 3)), 4)
    clip = _clip_u8(10)
    labels = np.random.default_rng(11).integers(0, C, (B,), dtype=np.int32)
    params = jax.tree.map(jnp.asarray, v["params"])
    cfg = {"learning_rate": 1e-3, "weight_decay": 0.05}
    tx = jeng.build_finetune_tx(cfg, "ft_random", params, False)
    jst = jstate.create_train_state(params, tx,
                                    batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]))
    new_jst, jm = jeng.make_train_step(jmodel, tx, seed=SEED, augment=jaug.augment_from_cfg(
        {"augment": kw}))(jst, {"clip": jnp.asarray(clip), "label": jnp.asarray(labels)})
    ref = classifier_state_dict_from_flax({"params": jax.tree.map(np.asarray, new_jst.params),
                                           "batch_stats": new_jst.batch_stats})
    draws = jax_draws(jax.random.fold_in(jax.random.key(SEED + 1), 0), B, **kw)

    def jax_drawn(clip_, generator):
        assert generator.initial_seed() == step_generator(SEED + 1, 0, "cpu").initial_seed()
        return taug.augment_clip(clip_, draws=draws, **kw)

    results = {}
    for name, augment in (("augmented", jax_drawn), ("plain", None)):
        port = VideoClassifier(TinyViTBackbone(embed_dims=DIMS), C)
        port.backbone.encoder = TinyViT(embed_dims=DIMS, depths=(1, 1, 1, 1),
                                        num_heads=(1, 2, 2, 2), drop_path_rate=0.0,
                                        use_checkpoint=False, num_stages=3)
        port.load_state_dict(classifier_state_dict_from_flax(v))
        state = tstate.create_train_state(port, teng.build_finetune_tx(cfg, "ft_random", port,
                                                                       False))
        step = teng.make_train_step(port, augment=augment, seed=SEED)
        state, m = step(state, {"clip": torch.from_numpy(clip),
                                "label": torch.from_numpy(labels)},
                        torch.Generator().manual_seed(0))
        results[name] = (port, state, m)
    port, state, m = results["augmented"]
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(results["plain"][2]["loss"]) != pytest.approx(float(jm["loss"]), rel=1e-3)
    adam = [a for a in jax.tree_util.tree_leaves(
        new_jst.opt_state, is_leaf=lambda a: isinstance(a, optax.ScaleByAdamState))
        if isinstance(a, optax.ScaleByAdamState)][0]
    ref_g = classifier_state_dict_from_flax({"params": jax.tree.map(np.asarray, adam.mu),
                                             "batch_stats": new_jst.batch_stats})
    opt = tstate.adamw_of(state.tx).opt
    named = dict(port.named_parameters())
    gmax = max(float(ref_g[n].abs().max()) for n in named) / 0.1
    for n, p in named.items():
        g = ref_g[n].numpy() / 0.1
        np.testing.assert_allclose((opt.state[p]["exp_avg"] / 0.1).numpy(), g, rtol=1e-4,
                                   atol=1e-4 * gmax, err_msg=n)
        # Adam's first step is about lr * sign(g): new params where |g| is clear
        sure = np.abs(g) > 1e-3 * gmax
        np.testing.assert_allclose(p.detach().numpy()[sure], ref[n].numpy()[sure],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for k, t in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref[k].numpy(), **NET_TOL, err_msg=k)


def test_the_step_draws_from_seed_plus_one_and_the_state_step():
    """Without injected draws the step's generator is step_generator(seed +
    1, state.step): its draws are the ones a run resumed at that step makes."""
    seen = []

    def record(clip, generator):
        seen.append(taug.draw_augment(generator, clip.shape[0]))
        return clip

    port = VideoClassifier(TinyViTBackbone(embed_dims=DIMS), C)
    state = tstate.create_train_state(port, teng.build_finetune_tx(
        {"learning_rate": 1e-3}, "ft_random", port, False))
    step = teng.make_train_step(port, augment=record, seed=SEED)
    batch = {"clip": torch.from_numpy(_clip_u8(12)), "label": torch.zeros(B, dtype=torch.int32)}
    drop = port.draw_drop_path(B, T, torch.Generator().manual_seed(0))
    for _ in range(2):
        step(state, batch, torch.Generator().manual_seed(0), drop=drop)
    for i, d in enumerate(seen):
        want = taug.draw_augment(step_generator(SEED + 1, i, "cpu"), B)
        torch.testing.assert_close(d.offsets, want.offsets, atol=0, rtol=0)
        torch.testing.assert_close(d.gain, want.gain, atol=0, rtol=0)
    assert not torch.equal(seen[0].offsets, seen[1].offsets)
