"""The port's ``data``, ``seq`` and ``client`` axes on gloo CPU process
groups against one device and against the JAX package, at toy widths, in
fp32.

One world of 2 ranks runs every regime, and one of 4 the sequence-parallel
ones, the way the JAX package's ``dryrun_multichip`` runs its regimes on
virtual devices: a pipeline-B step (dense, MoE with groups of 32 tokens,
and the long clip's sequence-parallel decoder over 2 and 4 ranks), a
pipeline-A step with VICReg and TOP (twice: the TOP subsample split over
the ranks, and all on one rank, the other's TOP batch empty), a pipeline-C
step, a finetune step with BatchNorm and ``evaluate``, the
sequence-parallel attention's forward and backward, and a FedAvg round of 3
clients on 2 ranks (padded to 4). The ranks run ``tests/torch_dist_ranks.py``
(no JAX) in their own processes, joined through a ``file://`` store; the
weights, the global batch and its draws are the JAX package's, written to a
file.

Each regime is held against the port's world-1 step on the global batch
(the same functions with no mesh, one thread as each rank) and the JAX
step: JAX's own mesh run where its CPU tests run that regime on a mesh
(``tests/test_parallel.py``: the sequence-parallel attention), otherwise
its single-device step, which those tests pin as equal to the mesh run.
The tolerances are those of the single-device parity tests of the same
step: metrics 1e-4 relative; gradients (Adam's first moment over 1 - b1)
1e-4 relative plus 1e-4 of the largest; the second moment 1e-3 plus 1e-8
of the largest squared; new params (where the gradient is not within 1e-4
of the largest of zero: Adam's first step is about lr * sign(g)) and
BatchNorm statistics 1e-4; the attention as ``test_parallel.py``'s. The
ranks' replicas agree to 1e-6 (torch's CPU kernels round the last bit by
the buffers' alignment). ``evaluate``'s top-k equals one device's exactly.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import torch_dist_ranks as ranks
from ssl_vit_video_analytics_tpu.data.masking import frame_mask as jax_frame_mask
from ssl_vit_video_analytics_tpu.data.masking import get_tube_mask as jax_tube_mask
from ssl_vit_video_analytics_tpu.federated import core as jfed
from ssl_vit_video_analytics_tpu.models.classifier import VideoClassifier as JaxClassifier
from ssl_vit_video_analytics_tpu.models.mae import TinyVideoMAE as JaxMAE
from ssl_vit_video_analytics_tpu.models.mae import TinyViTMAE as JaxTinyViTMAE
from ssl_vit_video_analytics_tpu.models.temporal import TemporalSSL as JaxTemporalSSL
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.ops.flash_attention import flash_attention_packed
from ssl_vit_video_analytics_tpu.parallel.mesh import make_mesh
from ssl_vit_video_analytics_tpu.parallel.sp import sp_attention_packed
from ssl_vit_video_analytics_tpu.train import finetune_engine as jft
from ssl_vit_video_analytics_tpu.train import mae_engine as jmae
from ssl_vit_video_analytics_tpu.train import ssl_engine as jssl
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu_torch.federated import core as tfed
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as tft
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    classifier_state_dict_from_flax, flatten_variables, mae_state_dict_from_flax,
    temporal_state_dict_from_flax, token_mae_state_dict_from_flax, unflatten_variables)

B, T, S = 4, 4, 32
L = (S // 8) ** 2
LR = 1e-3
DIMS, DEPTHS, HEADS = ranks.DIMS, ranks.DEPTHS, ranks.HEADS
MOE = dict(decoder_moe_experts=4, decoder_moe_capacity_factor=1.0, decoder_moe_group_size=32)
SSL_CFG = {"mask_ratio": 0.5, "mfm_weight": 1.0, "var_weight": 25.0, "var_target_std": 1.0,
           "var_eps": 1e-4, "top_weight": 1.0, "top_subsample": 0.5,
           "top_detach_backbone": False, "ema_momentum": 0.9}
FT_CFG = {"learning_rate": 1e-3, "weight_decay": 0.05}
CLASSES = 5
NET_TOL = dict(atol=1e-4, rtol=1e-4)
REPLICA_TOL = dict(atol=1e-6, rtol=1e-6)
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
# regimes of the 2-rank world; the 4-rank world runs the seq ones
WORLD2 = ["coll", "b_data", "b_moe", "b_seq", "a_split", "a_one", "c", "ft", "sp", "fed"]
WORLD4 = ["b_seq", "sp"]


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


def _u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def _jax_result(new, metrics, convert, ema=False) -> dict:
    """A JAX step's result in the port's names, as ``ranks._train_result``."""
    bs = jax.tree.map(np.asarray, new.batch_stats)

    def as_port(params):
        return convert({"params": jax.tree.map(np.asarray, params), "batch_stats": bs})

    def params_only(tree):  # the converter fills the BatchNorm buffers too
        return {k: v for k, v in tree.items() if not k.endswith(BUFFERS)}

    adam = _adam(new.opt_state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: v / 0.1 for k, v in params_only(as_port(adam.mu)).items()},
            "nu": params_only(as_port(adam.nu)), "state": as_port(new.params),
            "ema": params_only(as_port(new.ema_params)) if ema else None}


# --- the JAX models and their steps ---

def _jax_mae(**moe):
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, use_checkpoint=False,
                     drop_path_rate=0.0)
    return JaxMAE(encoder=enc, clip_len=T, img_size=S, patch_size=8, decoder_embed_dim=16,
                  decoder_depth=1, decoder_num_heads=2, **moe)


def _pixel_case(seed, moe: dict):
    model = _jax_mae(**moe)
    v = _perturb(jax.jit(lambda k: model.init(k, jnp.zeros((B, T, S, S, 3)),
                                              jnp.zeros((B, T, L), bool)))(
        jax.random.key(seed)), seed + 1)
    clip = _u8(seed + 2, B, T, S, S, 3)
    key = jax.random.key(seed + 3)
    k_mask, _ = jax.random.split(key)  # as make_pixel_mae_step splits its key
    mask = np.array(jax_tube_mask(k_mask, B, T, L, 0.75))
    aux = 0.01 if moe else 0.0
    spec = {"kind": "pixel_mae", "axis": "data", "state": mae_state_dict_from_flax(v),
            "clip": torch.from_numpy(clip), "mask": torch.from_numpy(mask), "lr": LR,
            "moe": moe, "moe_aux_weight": aux}

    def reference():
        jtx = jmae.wrap_accum_and_skip(jstate.make_optimizer(LR), accum_steps=1)
        jst = jstate.create_train_state(jax.tree.map(jnp.asarray, v["params"]), jtx,
                                        batch_stats=jax.tree.map(jnp.asarray,
                                                                 v["batch_stats"]))
        new, m = jmae.make_pixel_mae_step(model, jtx, mask_ratio=0.75, moe_aux_weight=aux)(
            jst, {"clip": jnp.asarray(clip)}, key)
        return _jax_result(new, m, mae_state_dict_from_flax)
    return spec, reference


def _ssl_case(seed, split: bool):
    """One pipeline-A step (the weights and clip of ``seed``) whose TOP
    subsample of 2 clips of 4 lies one on each rank of 2 (``split``), or
    both on the second: the first draw key that does so."""
    model = JaxTemporalSSL(embed_dim=16, layers=1, heads=2, clip_len=T)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((B, T, S, S, 3)), method="init_all"))(
        jax.random.key(seed))
    student, ema = _perturb(v, seed + 1), _perturb({"params": v["params"]}, seed + 2)["params"]
    clip = _u8(seed + 3, B, T, S, S, 3)
    k = max(2, int(B * SSL_CFG["top_subsample"]))
    for n in range(100):
        key = jax.random.key(1000 * seed + n)
        k_mask, k_sel, k_perm, _, _ = jax.random.split(key, 5)  # as make_ssl_step splits
        sel = np.asarray(jax.random.permutation(k_sel, B)[:k])
        if ((sel < B // 2).sum() == 1) == split and (split or (sel >= B // 2).all()):
            break
    mask = np.asarray(jax_frame_mask(k_mask, B, T, SSL_CFG["mask_ratio"]))
    labels = np.asarray(jax.random.randint(k_perm, (k,), 0, 4))
    sd = temporal_state_dict_from_flax(student)
    ema_sd = temporal_state_dict_from_flax({"params": ema, "batch_stats": student["batch_stats"]})
    spec = {"kind": "ssl", "axis": "data", "state": sd, "ema": ema_sd,
            "clip": torch.from_numpy(clip), "mask": torch.from_numpy(mask),
            "top_sel": torch.from_numpy(sel).long(), "top_labels": torch.from_numpy(labels).long(),
            "cfg": SSL_CFG, "lr": LR}

    def reference():
        jtx = jstate.make_optimizer(LR, grad_clip=1.0)
        jst = jstate.create_train_state(jax.tree.map(jnp.asarray, student["params"]), jtx,
                                        batch_stats=jax.tree.map(jnp.asarray,
                                                                 student["batch_stats"]),
                                        ema_params=jax.tree.map(jnp.asarray, ema))
        new, m = _jax_ssl_step(model, jtx)(jst, {"clip": jnp.asarray(clip)}, key)
        return _jax_result(new, m, temporal_state_dict_from_flax, ema=True)
    return spec, reference


_JAX_SSL = {}


def _jax_ssl_step(model, jtx):
    """One jitted JAX pipeline-A step for both pipeline-A regimes."""
    if "step" not in _JAX_SSL:
        _JAX_SSL["step"] = jssl.make_ssl_step(model, jtx, SSL_CFG, with_top=True)
    return _JAX_SSL["step"]


def _token_case(seed):
    Tc, P = 2, 4
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, use_checkpoint=False,
                     drop_path_rate=0.0)
    model = JaxTinyViTMAE(encoder=enc, stage4_pool=2, decoder_dim=16, decoder_depth=1,
                          decoder_num_heads=2)
    v = _perturb(jax.jit(lambda k: model.init(k, jnp.zeros((B, Tc, S, S, 3)),
                                              jnp.zeros((B, Tc * P), bool)))(
        jax.random.key(seed)), seed + 1)
    clip = _u8(seed + 2, B, Tc, S, S, 3)
    ratio = 0.75
    key = jax.random.key(seed + 3)
    k_mask, _, k_flip = jax.random.split(key, 3)  # as make_token_mae_step splits
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (B, 1, 1, 1, 1))).reshape(B)
    noise = jax.random.uniform(k_mask, (B, P))
    order = jnp.argsort(jnp.argsort(noise, axis=-1, descending=True), axis=-1)
    mask = np.tile(np.asarray(order < jnp.maximum(1, jnp.round(P * jnp.float32(ratio)))
                              .astype(jnp.int32)), (1, Tc))
    spec = {"kind": "token_mae", "axis": "data", "state": token_mae_state_dict_from_flax(v),
            "clip": torch.from_numpy(clip), "mask": torch.from_numpy(mask),
            "flip": torch.from_numpy(flip), "ratio": ratio, "lr": LR}

    def reference():
        jtx = jmae.wrap_accum_and_skip(jstate.make_optimizer(LR))
        jst = jstate.create_train_state(jax.tree.map(jnp.asarray, v["params"]), jtx,
                                        batch_stats=jax.tree.map(jnp.asarray,
                                                                 v["batch_stats"]))
        new, m = jmae.make_token_mae_step(model, jtx, tokens_per_frame=P, mask_mode="tube",
                                          augment_hflip=True)(
            jst, {"clip": jnp.asarray(clip)}, key, jnp.float32(ratio))
        return _jax_result(new, m, token_mae_state_dict_from_flax)
    return spec, reference


class _StepBackbone(fnn.Module):
    """TinyViTBackbone's tree (``encoder``, stage limit 3), toy depths, no
    stochastic depth."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        feat = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                          use_checkpoint=False, name="encoder")(x, train=train, stage_limit=3)
        return feat, jnp.mean(feat, axis=(1, 2))


def _finetune_case(seed):
    model = JaxClassifier(backbone=_StepBackbone(), num_classes=CLASSES)
    v = _perturb(jft.init_model(model, jax.random.key(seed), (B, T, S, S, 3)), seed + 1)
    clip, label = _u8(seed + 2, B, T, S, S, 3), np.array([0, 3, 4, 1], np.int32)
    # two eval batches, the second with a padded tail
    evals = [{"clip": _u8(seed + 3 + i, B, T, S, S, 3),
              "label": np.random.default_rng(seed + 5 + i).integers(0, CLASSES, B)
              .astype(np.int32),
              "valid": np.array([True] * B if i == 0 else [True, True, True, False])}
             for i in range(2)]
    spec = {"kind": "finetune", "axis": "data", "classes": CLASSES,
            "state": classifier_state_dict_from_flax(v), "cfg": FT_CFG,
            "clip": torch.from_numpy(clip), "label": torch.from_numpy(label),
            "eval_batches": [{k: torch.from_numpy(x) for k, x in b.items()} for b in evals]}

    def reference():
        params = jax.tree.map(jnp.asarray, v["params"])
        tx = jft.build_finetune_tx(FT_CFG, "ft_random", params, False)
        jst = jstate.create_train_state(params, tx, batch_stats=jax.tree.map(
            jnp.asarray, v["batch_stats"]))
        top = jft.evaluate(jft.make_eval_step(model), jst,
                           [{k: jnp.asarray(x) for k, x in b.items()} for b in evals])
        new, m = jft.make_train_step(model, tx)(
            jst, {"clip": jnp.asarray(clip), "label": jnp.asarray(label)})
        return {**_jax_result(new, m, classifier_state_dict_from_flax), "eval": top}
    return spec, reference


def _sp_case(seed):
    rng = np.random.default_rng(seed)
    Bq, Lq, H, d = 2, 64, 2, 32
    qkv = {n: rng.standard_normal((Bq, Lq, H * d)).astype(np.float32) for n in "qkv"}
    spec = {"kind": "sp_attention", "axis": "seq", "heads": H,
            **{n: torch.from_numpy(x) for n, x in qkv.items()}}

    def reference(world):
        """JAX's own mesh run, as ``test_parallel.py``'s: sp_attention_packed
        over a seq mesh of ``world`` devices, gradients of sum(sin(out))."""
        mesh = make_mesh({"seq": world}, devices=jax.devices()[:world])
        q, k, v = (jnp.asarray(qkv[n]) for n in "qkv")
        out = sp_attention_packed(q, k, v, H, mesh)
        grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
            sp_attention_packed(q, k, v, H, mesh))), argnums=(0, 1, 2))(q, k, v)
        single = flash_attention_packed(q, k, v, H)
        np.testing.assert_allclose(np.asarray(out), np.asarray(single), atol=2e-5, rtol=2e-5)
        return {"out": np.asarray(out), **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}
    return spec, reference


def _fed_case(seed):
    """3 clients of ragged length (2, 2 and 1 steps of 2 clips) on a
    MobileViT-S classifier with the port's seeded init."""
    model = tft.init_model(tft.build_model(CLASSES, 16), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    batches = {"clip": rng.integers(0, 256, (3, 2, 2, 2, S, S, 3), dtype=np.uint8),
               "label": rng.integers(0, CLASSES, (3, 2, 2)).astype(np.int32),
               "valid": np.array([[[1, 1], [1, 0]], [[1, 1], [0, 0]], [[1, 0], [0, 0]]], bool)}
    spec = {"kind": "fedavg", "axis": "client", "classes": CLASSES,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "batches": batches, "sizes": np.array([3.0, 2.0, 1.0], np.float32)}
    return spec, None


# --- the worlds ---

def _launch(tmp, world, names):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_ranks.py")
    return [subprocess.Popen([sys.executable, script, tmp, str(r), str(world), ",".join(names)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _wait(procs, tmp, world, deadline):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
        outs.append(out.decode(errors="replace"))
    assert [p.returncode for p in procs] == [0] * world, "\n".join(outs)[-4000:]
    return [torch.load(os.path.join(tmp, f"rank{r}_w{world}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every regime: the ranks' results of both worlds, the port's world-1
    results and the JAX references."""
    cases = {"b_data": _pixel_case(0, {}), "b_moe": _pixel_case(10, MOE),
             "a_split": _ssl_case(20, True), "a_one": _ssl_case(20, False),
             "c": _token_case(40), "ft": _finetune_case(50), "sp": _sp_case(60),
             "fed": _fed_case(70)}
    cases["b_seq"] = ({**cases["b_data"][0], "axis": "seq", "sp": True}, cases["b_data"][1])
    specs = {n: c[0] for n, c in cases.items()}
    g = torch.Generator().manual_seed(80)
    specs["coll"] = {"kind": "collectives", "axis": "data", "xs": torch.randn(2, 5, generator=g),
                     "c": torch.randn(2, 5, generator=g), "d": torch.randn(2, 2, 5, generator=g)}
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    for d in dirs.values():
        torch.save(specs, os.path.join(d, "inputs.pt"))
    deadline = time.time() + 600
    procs = {2: _launch(dirs[2], 2, WORLD2), 4: _launch(dirs[4], 4, WORLD4)}
    try:
        jax_ref = {n: c[1]() for n, c in cases.items()
                   if c[1] is not None and n not in ("sp", "b_seq")}
        jax_ref["b_seq"] = jax_ref["b_data"]
        jax_ref["sp"] = {w: cases["sp"][1](w) for w in (2, 4)}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as each rank: the same CPU kernels' rounding
        try:
            world1 = {n: ranks.run_regime(spec, None) for n, spec in specs.items()
                      if n != "coll"}
        finally:
            torch.set_num_threads(threads)
        worlds = {w: _wait(procs[w], dirs[w], w, deadline) for w in (2, 4)}
    finally:
        for p in procs[2] + procs[4]:
            if p.poll() is None:
                p.kill()
    return {"specs": specs, "jax": jax_ref, "world1": world1, "worlds": worlds}


# --- the comparisons ---

def _close(got, want, msg, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


def _hold_step(got: dict, want: dict, what: str):
    """A train step's result against a reference, at the single-device
    parity tests' tolerances."""
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-4), (what, k)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in want["grads"].values())
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        g = np.asarray(g)
        _close(got["grads"][name], g, f"{what} grad {name}", rtol=1e-4, atol=1e-4 * gmax)
        _close(got["nu"][name], want["nu"][name], f"{what} nu {name}", rtol=1e-3,
               atol=1e-8 * gmax ** 2)
        sure = np.abs(g) > 1e-4 * gmax
        _close(np.asarray(got["state"][name])[sure], np.asarray(want["state"][name])[sure],
               f"{what} param {name}", **NET_TOL)
        if want.get("ema") is not None:
            _close(np.asarray(got["ema"][name])[sure], np.asarray(want["ema"][name])[sure],
                   f"{what} ema {name}", **NET_TOL)
    for key, t in want["state"].items():
        if key.endswith(("running_mean", "running_var")):
            _close(got["state"][key], t, f"{what} {key}", **NET_TOL)


def _hold_replicas(results: list, name: str):
    """Every rank ends the step with rank 0's replica."""
    for r, res in enumerate(results[1:], 1):
        for key, t in results[0][name]["state"].items():
            _close(res[name]["state"][key], t, f"rank {r} {name} {key}", **REPLICA_TOL)


@pytest.mark.parametrize("name,world", [("b_data", 2), ("b_moe", 2), ("b_seq", 2),
                                        ("b_seq", 4), ("a_split", 2), ("a_one", 2),
                                        ("c", 2), ("ft", 2)])
def test_train_step_over_ranks_matches_one_device_and_jax(runs, name, world):
    results = runs["worlds"][world]
    got = results[0][name]
    _hold_step(got, runs["world1"][name], f"{name} world {world} vs world 1")
    _hold_step(got, runs["jax"][name], f"{name} world {world} vs JAX")
    _hold_replicas(results, name)
    if name == "b_moe":
        assert 1 / 4 <= got["metrics"]["moe_aux"] <= 4


def test_collectives_and_their_backward_over_two_ranks(runs):
    """all_reduce_sum: the sum forward, and each rank's gradient the sum of
    every rank's upstream gradient; all_gather: the ranks' tensors in rank
    order, and each rank's gradient the sum over the ranks of the upstream
    gradient's block that is its own (a reduce-scatter)."""
    spec = runs["specs"]["coll"]
    xs, c, d = spec["xs"], spec["c"], spec["d"]
    for r, res in enumerate(runs["worlds"][2]):
        got = res["coll"]
        torch.testing.assert_close(got["y"], xs.sum(0))
        torch.testing.assert_close(got["gy"], c.sum(0))
        torch.testing.assert_close(got["z"], xs)
        torch.testing.assert_close(got["gz"], d[:, r].sum(0))


def test_evaluate_top_k_over_ranks_equals_one_device(runs):
    got = [res["ft"]["eval"] for res in runs["worlds"][2]]
    assert got[0] == got[1] == runs["world1"]["ft"]["eval"] == runs["jax"]["ft"]["eval"]
    # 7 valid clips of 8: the padded one is not counted
    assert all(abs(v * 7 - round(v * 7)) < 1e-9 for v in got[0].values())


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_attention_matches_one_device_and_jax(runs, world):
    got = runs["worlds"][world][0]["sp"]
    assert all(torch.equal(r["sp"]["out"], got["out"]) for r in runs["worlds"][world])
    for key in ("out", "dq", "dk", "dv"):
        _close(got[key], runs["world1"]["sp"][key], f"sp {key} vs world 1",
               atol=1e-5, rtol=1e-5)
        tol = 2e-5 if key == "out" else 5e-5  # test_parallel.py's
        _close(got[key], runs["jax"]["sp"][world][key], f"sp {key} vs JAX", atol=tol, rtol=tol)


def test_fedavg_round_over_the_client_axis_matches_one_device_and_jax(runs):
    spec, world1 = runs["specs"]["fed"], runs["world1"]["fed"]
    results = [res["fed"] for res in runs["worlds"][2]]
    # the padding of 3 clients to 2 ranks: the JAX package's
    padded, sizes, n = tfed.pad_clients_to_axis(spec["batches"], spec["sizes"], 2)
    jpadded, jsizes, jn = jfed.pad_clients_to_axis(spec["batches"], spec["sizes"], 2)
    assert n == jn == 3 and np.array_equal(sizes, jsizes) and sizes.tolist() == [3, 2, 1, 0]
    assert all(np.array_equal(padded[k], jpadded[k]) for k in padded)
    # the JAX aggregate of the one-device clients' states, with the dummy
    # client (the global state, weight 0)
    states = world1["client_states"] + [spec["state"]]
    stacked = {k: np.stack([s[k].numpy() for s in states]) for k in spec["state"]}
    jagg = jax.tree.map(np.asarray, jfed.fedavg_aggregate(stacked, jnp.asarray(jsizes)))
    for res in results:
        _close(res["losses"], world1["losses"], "client losses", rtol=1e-6, atol=0)
        assert res["losses"].shape == (3,)
        for key, t in world1["state"].items():
            if t.is_floating_point():
                _close(res["state"][key], t, f"aggregate {key} vs world 1", rtol=1e-5, atol=1e-6)
                _close(res["state"][key], jagg[key], f"aggregate {key} vs JAX", rtol=1e-5,
                       atol=1e-6)
            else:  # num_batches_tracked: the max over clients
                assert torch.equal(res["state"][key], t) and int(t) == int(jagg[key]), key
