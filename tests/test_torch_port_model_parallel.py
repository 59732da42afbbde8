"""The port's model sharding (``expert``, ``model`` and ``pipe`` axes) on
gloo CPU process groups against one device and against the JAX package,
at toy widths, in fp32.

One world of 2 ranks and one of 4 run every regime, the way
``tests/test_torch_port_dist_parity.py`` runs the data, seq and client
axes (the ranks run ``tests/torch_dist_ranks.py``, no JAX, through a
``file://`` store; the weights, the global batch and its draws are the JAX
package's):

- EP: the MoE decoder (4 experts, groups of 32 tokens) over
  ``{data: 1, expert: 2}`` and ``{data: 2, expert: 2}``, and routed as one
  group of the global batch (``decoder_moe_group_size: 0``) over
  ``{data: 2}``, ``{seq: 2}`` (each clip's frames split) and ``{data: 2,
  expert: 2}``;
- TP: pipeline B over ``{data: 1, model: 2}`` with whole heads, with 3
  decoder heads (split 2 and 1) and an encoder stage of one head (a rank
  with none), and over ``{data: 2, model: 2}``; pipeline C's token MAE over
  ``{data: 1, model: 2}``, clipped by the global norm, with its checkpoint;
- PP: a 4-block decoder over 2 stages in 2 and in 4 microbatches, and over
  4 stages.

Each regime's result, gathered whole on every rank (the checkpoint a mesh
writes), is held against the port's world-1 step on the global batch and
the JAX step: JAX's own mesh run where its CPU tests run that regime on a
mesh and holds it to its single-device step (``tests/test_ep.py``'s pixel
step under an ``{expert: 2}`` mesh; ``tests/test_pp.py::
test_pixel_mae_step_pp_matches_plain``'s ``pipe`` mesh), else its
single-device step. One JAX step serves the regimes that share its
weights. JAX's steps under two-axis meshes are not references: under
``{data: 2, expert: 2}`` and under ``{data: 2, model: 2}`` (``tests/
test_parallel.py::test_tp_step_matches_replicated`` holds only its loss)
they return the single-device loss but miss its depthwise-conv gradients;
the last test pins that fault of the reference and holds the port's loss
to JAX's TP mesh run. The tolerances are the data-parallel parity
test's:
metrics 1e-4 relative; gradients 1e-4 relative plus 1e-4 of the largest;
Adam's second moment 1e-3 plus 1e-8 of the largest squared; new params
and BatchNorm statistics 1e-4; the ranks agree to 1e-6. Each rank holds
exactly its experts, its heads' rows and columns, its MLP units or its
stage's blocks, with AdamW moments of the same shapes.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_ranks as ranks
from test_torch_port_dist_parity import (_hold_replicas, _hold_step, _jax_result, _launch,
                                         _perturb, _u8, _wait)
from ssl_vit_video_analytics_tpu.data.masking import get_tube_mask as jax_tube_mask
from ssl_vit_video_analytics_tpu.models.mae import TinyVideoMAE as JaxMAE
from ssl_vit_video_analytics_tpu.models.mae import TinyViTMAE as JaxTinyViTMAE
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.parallel.ep import set_ep_mesh, shard_state_ep
from ssl_vit_video_analytics_tpu.parallel.mesh import make_mesh
from ssl_vit_video_analytics_tpu.parallel.tp import shard_params_tp
from ssl_vit_video_analytics_tpu.train import mae_engine as jmae
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu_torch.utils.convert import (mae_state_dict_from_flax,
                                                             token_mae_state_dict_from_flax)

B, T, S = 4, 4, 32
L = (S // 8) ** 2
LR = 1e-3
DIMS, DEPTHS, HEADS = ranks.DIMS, ranks.DEPTHS, ranks.HEADS
MOE = dict(decoder_moe_experts=4, decoder_moe_capacity_factor=1.25, decoder_moe_group_size=32)
MOE_GLOBAL = dict(MOE, decoder_moe_group_size=0)
EVEN_HEADS = (2, 2, 2, 2)             # every attention splits evenly over 2
ODD_HEADS = (1, 1, 3, 2)              # stage 1: one head (a rank holds none)
DEC_H3 = {"decoder_embed_dim": 24, "decoder_num_heads": 3}   # heads split 2, 1
DEC_DEEP = {"decoder_depth": 4}
CLIP_C = 0.01                         # pipeline C's clip, small enough to bite
# regime: (case, mesh, extra spec entries)
WORLD2 = {"ep2": ("moe", {"data": 1, "expert": 2}, {}),
          "moe_global_dp2": ("moe_global", {"data": 2}, {}),
          "moe_global_seq2": ("moe_global", {"seq": 2}, {"sp": True}),
          "tp2": ("tp_even", {"data": 1, "model": 2}, {}),
          "tp2_h3": ("tp_odd", {"data": 1, "model": 2}, {}),
          "c_tp2": ("token", {"data": 1, "model": 2}, {"checkpoint": True}),
          "pp2_m2": ("deep", {"pipe": 2}, {"n_micro": 2}),
          "pp2_m4": ("deep", {"pipe": 2}, {"n_micro": 4})}
WORLD4 = {"dp2ep2": ("moe", {"data": 2, "expert": 2}, {}),
          "moe_global_dp2ep2": ("moe_global", {"data": 2, "expert": 2}, {}),
          "dp2tp2": ("tp_even", {"data": 2, "model": 2}, {}),
          "pp4": ("deep", {"pipe": 4}, {"n_micro": 4})}


def _jax_mae(heads=HEADS, **kw):
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=heads, use_checkpoint=False,
                     drop_path_rate=0.0)
    dec = {"decoder_embed_dim": 16, "decoder_depth": 1, "decoder_num_heads": 2, **kw}
    return JaxMAE(encoder=enc, clip_len=T, img_size=S, patch_size=8, **dec)


def _jax_devices(n):
    return jax.devices()[:n]


def _pixel_case(seed, mesh_run=None, heads=HEADS, moe=None, decoder=None):
    """A pipeline-B spec (the JAX weights of ``seed``, perturbed) and its
    JAX reference: the single-device step, or ``mesh_run(model, v, clip,
    key)``."""
    model = _jax_mae(heads, **(moe or {}), **(decoder or {}))
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
            "moe": moe or {}, "moe_aux_weight": aux, "heads": heads, "decoder": decoder or {}}

    def reference():
        jtx = jmae.wrap_accum_and_skip(jstate.make_optimizer(LR), accum_steps=1)
        params, bs = (jax.tree.map(jnp.asarray, v[k]) for k in ("params", "batch_stats"))
        batch, kw = {"clip": jnp.asarray(clip)}, {}
        if mesh_run is not None:
            params, bs, batch, kw = mesh_run(params, bs, batch)
        jst = jstate.create_train_state(params, jtx, batch_stats=bs)
        try:
            new, m = jmae.make_pixel_mae_step(model, jtx, mask_ratio=0.75,
                                              moe_aux_weight=aux, **kw)(jst, batch, key)
            return _jax_result(new, m, mae_state_dict_from_flax)
        finally:
            set_ep_mesh(None)
    return spec, reference


def _ep_mesh_run(params, bs, batch, axes=None):
    """JAX's EP, as tests/test_ep.py runs its pixel step: the banks over an
    ``{expert: 2}`` mesh (``axes``: another mesh, the batch over its data
    axis)."""
    axes = axes or {"expert": 2}
    mesh = make_mesh(axes, devices=_jax_devices(int(np.prod(list(axes.values())))))
    set_ep_mesh(mesh)
    params = shard_state_ep(params, mesh)
    if "data" in axes:
        batch = {"clip": jax.device_put(batch["clip"], NamedSharding(mesh, P("data")))}
    return params, jax.device_put(bs, NamedSharding(mesh, P())), batch, {}


def _tp_mesh_run(params, bs, batch):
    """JAX's TP, as test_tp_step_matches_replicated: params by its rules
    over {data: 2, model: 2}, the batch over data."""
    mesh = make_mesh({"data": 2, "model": 2}, devices=_jax_devices(4))
    return (shard_params_tp(params, mesh), jax.device_put(bs, NamedSharding(mesh, P())),
            {"clip": jax.device_put(batch["clip"], NamedSharding(mesh, P("data")))}, {})


def _pp_mesh_run(params, bs, batch):
    """JAX's PP: the decoder's blocks over a 2-stage pipe mesh, 2
    microbatches."""
    return params, bs, batch, {"pp_mesh": make_mesh({"pipe": 2}, devices=_jax_devices(2)),
                               "pp_microbatches": 2}


def _token_case(seed):
    Tc, Pt = 2, 4
    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, use_checkpoint=False,
                     drop_path_rate=0.0)
    model = JaxTinyViTMAE(encoder=enc, stage4_pool=2, decoder_dim=16, decoder_depth=1,
                          decoder_num_heads=2)
    v = _perturb(jax.jit(lambda k: model.init(k, jnp.zeros((B, Tc, S, S, 3)),
                                              jnp.zeros((B, Tc * Pt), bool)))(
        jax.random.key(seed)), seed + 1)
    clip = _u8(seed + 2, B, Tc, S, S, 3)
    ratio = 0.75
    key = jax.random.key(seed + 3)
    k_mask, _, k_flip = jax.random.split(key, 3)  # as make_token_mae_step splits
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (B, 1, 1, 1, 1))).reshape(B)
    noise = jax.random.uniform(k_mask, (B, Pt))
    order = jnp.argsort(jnp.argsort(noise, axis=-1, descending=True), axis=-1)
    mask = np.tile(np.asarray(order < jnp.maximum(1, jnp.round(Pt * jnp.float32(ratio)))
                              .astype(jnp.int32)), (1, Tc))
    spec = {"kind": "token_mae", "axis": "data", "state": token_mae_state_dict_from_flax(v),
            "clip": torch.from_numpy(clip), "mask": torch.from_numpy(mask),
            "flip": torch.from_numpy(flip), "ratio": ratio, "lr": LR, "clip_norm": CLIP_C}

    def reference():
        jtx = jmae.wrap_accum_and_skip(jstate.make_optimizer(LR, grad_clip=CLIP_C))
        jst = jstate.create_train_state(jax.tree.map(jnp.asarray, v["params"]), jtx,
                                        batch_stats=jax.tree.map(jnp.asarray,
                                                                 v["batch_stats"]))
        new, m = jmae.make_token_mae_step(model, jtx, tokens_per_frame=Pt, mask_mode="tube",
                                          augment_hflip=True)(
            jst, {"clip": jnp.asarray(clip)}, key, jnp.float32(ratio))
        return _jax_result(new, m, token_mae_state_dict_from_flax)
    return spec, reference


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every regime: the ranks' results of both worlds, the port's world-1
    result of each case and the JAX references."""
    cases = {"moe": _pixel_case(100, _ep_mesh_run, moe=MOE),
             "moe_global": _pixel_case(110, moe=MOE_GLOBAL),
             "tp_even": _pixel_case(120, heads=EVEN_HEADS),
             "tp_odd": _pixel_case(130, heads=ODD_HEADS, decoder=DEC_H3),
             "token": _token_case(140),
             "deep": _pixel_case(150, _pp_mesh_run, decoder=DEC_DEEP)}
    dirs, procs = {}, {}
    for world, regimes in ((2, WORLD2), (4, WORLD4)):
        specs = {name: {**cases[case][0], **extra, "mesh": mesh}
                 for name, (case, mesh, extra) in regimes.items()}
        dirs[world] = str(tmp_path_factory.mktemp(f"world{world}"))
        torch.save(specs, os.path.join(dirs[world], "inputs.pt"))
    deadline = time.time() + 600
    procs = {w: _launch(dirs[w], w, list(r)) for w, r in ((2, WORLD2), (4, WORLD4))}
    try:
        jax_ref = {case: ref() for case, (_, ref) in cases.items()}
        # the two-axis mesh runs of the reference (see the last test)
        jax_ref["moe_2d"] = _pixel_case(100, lambda *a: _ep_mesh_run(
            *a, axes={"data": 2, "expert": 2}), moe=MOE)[1]()
        jax_ref["tp_2d"] = _pixel_case(120, _tp_mesh_run, heads=EVEN_HEADS)[1]()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as each rank: the same CPU kernels' rounding
        try:
            world1 = {case: ranks.run_regime({**spec, "checkpoint": case == "token"}, None)
                      for case, (spec, _) in cases.items()}
        finally:
            torch.set_num_threads(threads)
        worlds = {w: _wait(procs[w], dirs[w], w, deadline) for w in (2, 4)}
    finally:
        for p in procs[2] + procs[4]:
            if p.poll() is None:
                p.kill()
    return {"jax": jax_ref, "world1": world1, "worlds": worlds}


REGIMES = [(name, 2) for name in WORLD2] + [(name, 4) for name in WORLD4]


@pytest.mark.parametrize("name,world", REGIMES)
def test_sharded_step_matches_one_device_and_jax(runs, name, world):
    case = {**WORLD2, **WORLD4}[name][0]
    results = runs["worlds"][world]
    want1, want_jax = runs["world1"][case], runs["jax"][case]
    for r, res in enumerate(results):
        got = res[name]
        assert set(got["state"]) == set(want1["state"])
        assert all(got["state"][k].shape == t.shape for k, t in want1["state"].items())
        _hold_step(got, want1, f"{name} rank {r} vs world 1")
        _hold_step(got, want_jax, f"{name} rank {r} vs JAX")
    _hold_replicas(results, name)
    # every rank meets the same all-reduces and gathers (the sends and
    # receives of a pipeline differ by stage)
    calls = [{k: n for k, n in res[name]["collectives"].items() if k not in ("send", "recv")}
             for res in results]
    assert all(c == calls[0] for c in calls), calls
    if case.startswith("moe"):
        assert 1 / 4 <= results[0][name]["metrics"]["moe_aux"] <= 4


def _coords(mesh: dict, rank: int) -> dict:
    """A rank's position on a mesh laid out row-major."""
    out = {}
    for axis, n in reversed(list(mesh.items())):
        out[axis] = rank % n
        rank //= n
    return out


def _heads(num_heads, tp, r):
    """Rank r's heads: blocks as even as whole heads go, larger first."""
    sizes = [num_heads // tp + (i < num_heads % tp) for i in range(tp)]
    return sizes[r]


def _expected_shape(name: str, full: tuple, case: str, mesh: dict, r: int) -> tuple:
    """The shape of what rank r should hold of param ``name`` (whole shape
    ``full``)."""
    c = _coords(mesh, r)
    parts = ["", "", ""] + name.split(".")
    if "expert" in mesh and parts[-2] == "mlp" and parts[-1] in ("w1", "b1", "w2", "b2"):
        return (full[0] // mesh["expert"],) + full[1:]
    if "pipe" in mesh and name.startswith("decoder.blocks."):
        depth, stages = DEC_DEEP["decoder_depth"], mesh["pipe"]
        stage = int(parts[5]) // (depth // stages)
        return full if stage == c["pipe"] else (0,) + full[1:]
    if "model" in mesh:
        tp, layer = mesh["model"], parts[-2]
        if parts[-3] == "attn" and layer in ("qkv", "proj") and name.endswith("weight") or \
                name.endswith("qkv.bias"):
            heads = _head_count(name, case)
            d = (full[0] // 3 if layer == "qkv" else full[1]) // heads
            own = _heads(heads, tp, c["model"]) * d
            return (3 * own,) + full[1:] if layer == "qkv" else (full[0], own)
        if parts[-3] == "mlp" and (name.endswith("fc1.weight") or name.endswith("fc1.bias")):
            return (full[0] // tp,) + full[1:]
        if parts[-3] == "mlp" and name.endswith("fc2.weight"):
            return (full[0], full[1] // tp)
    return full


def _head_count(name: str, case: str) -> int:
    """The heads of the attention layer that param ``name`` belongs to."""
    if name.startswith("decoder."):
        return 3 if case == "tp_odd" else 2
    heads = {"tp_even": EVEN_HEADS, "tp_odd": ODD_HEADS}.get(case, HEADS)
    return heads[int(name.split("stages.")[1].split(".")[0])]


@pytest.mark.parametrize("name,world", REGIMES)
def test_each_rank_holds_only_its_shard_and_its_moments(runs, name, world):
    case, mesh, _ = {**WORLD2, **WORLD4}[name]
    full = {k: tuple(t.shape) for k, t in runs["world1"][case]["state"].items()}
    cut = 0
    for r, res in enumerate(runs["worlds"][world]):
        held = res[name]["held"]
        assert set(held) == set(runs["world1"][case]["grads"])
        for pname, (param, mu, nu) in held.items():
            want = _expected_shape(pname, full[pname], case, mesh, r)
            assert param == mu == nu == want, (name, r, pname, param, want)
            cut += want != full[pname]
    assert cut > 0 or not {"expert", "model", "pipe"} & set(mesh)
    if case == "tp_odd":  # the one-head encoder stage: rank 1 holds none of it
        qkv = [k for k in full if k.endswith("attn.qkv.weight") and "stages.1" in k]
        assert qkv and all(runs["worlds"][world][1][name]["held"][k][0][0] == 0 for k in qkv)


def test_pipeline_c_checkpoint_under_tp_is_one_devices_and_resumes_exactly(runs):
    """The whole checkpoint (model and optimizer) that ``entry/train_mae``
    writes under {data: 1, model: 2} equals one device's, and cutting it
    back gives every rank bit for bit what it held."""
    want = runs["world1"]["token"]["checkpoint"]
    # the largest clipped gradient (Adam's first moment over 1 - b1)
    gmax = max(float(g.abs().max()) for g in runs["world1"]["token"]["grads"].values())
    for r, res in enumerate(runs["worlds"][2]):
        got = res["c_tp2"]["checkpoint"]
        assert got["resume_exact"], r
        assert set(got["model"]) == set(want["model"]) and set(got["opt"]) == set(want["opt"])
        for key, t in want["opt"].items():
            assert got["opt"][key].shape == t.shape, key
            if key.endswith(("count", "step", "mini_step", "notfinite_count")) or t.dim() == 0:
                assert torch.equal(got["opt"][key], t), key
            elif key.endswith("exp_avg_sq"):  # as _hold_step holds the moments
                np.testing.assert_allclose(got["opt"][key], t, rtol=1e-3,
                                           atol=1e-8 * gmax ** 2, err_msg=key)
            else:  # exp_avg, (1 - b1) times the (clipped) gradient
                np.testing.assert_allclose(got["opt"][key], t, rtol=1e-4,
                                           atol=0.1 * 1e-4 * gmax, err_msg=key)
        for key, t in want["model"].items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got["model"][key], t, rtol=1e-4, atol=1e-4,
                                           err_msg=key)


@pytest.mark.parametrize("case,mesh_run,regime", [("moe", "moe_2d", "dp2ep2"),
                                                 ("tp_even", "tp_2d", "dp2tp2")])
def test_jax_two_axis_mesh_steps_miss_their_single_device_gradients(runs, case, mesh_run,
                                                                    regime):
    """A fault of the reference, pinned so that its repair shows: the JAX
    package's pixel step under ``{data: 2, expert: 2}`` and under ``{data:
    2, model: 2}`` returns its single-device loss (the port's, as JAX's TP
    test holds) but depthwise-conv gradients that miss its single-device
    step's by more than 1e-3 of the largest gradient, while the port's
    step under the same meshes holds to the single-device step (above)."""
    mesh, one = runs["jax"][mesh_run], runs["jax"][case]
    port = runs["worlds"][4][0][regime]
    assert mesh["metrics"]["loss"] == pytest.approx(one["metrics"]["loss"], rel=1e-5)
    assert port["metrics"]["loss"] == pytest.approx(mesh["metrics"]["loss"], rel=1e-4)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in one["grads"].values())
    miss = {k: float(np.abs(np.asarray(mesh["grads"][k]) - np.asarray(g)).max()) / gmax
            for k, g in one["grads"].items()}
    worst = max(miss, key=miss.get)
    assert miss[worst] > 1e-3 and worst.endswith("dw.conv.weight"), (worst, miss[worst])


class _Lines:
    """A mesh's shape as JAX's ``count_*`` read it."""

    def __init__(self, **shape):
        self.shape = shape


def _cut_port(model, axes: dict):
    """``model`` cut as rank 0 of a mesh ``axes`` (no process group: only
    the layout is read)."""
    from ssl_vit_video_analytics_tpu_torch.parallel import mesh as pmesh
    from ssl_vit_video_analytics_tpu_torch.parallel.shard import shard_model

    shard_model(model, pmesh.Mesh(tuple(axes.items()), (0,) * len(axes), (None,) * len(axes)))
    return model


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_leaf_counts_of_the_entries_log_lines_against_jax(tp):
    """``EP: n/N`` and ``TP: n/N``: the port's counts of the leaves it cuts
    against JAX's ``count_bank_sharded`` and ``count_sharded`` on the same
    models (shapes only). EP and pipeline B's TP agree; under pipeline C's
    TP JAX also cuts the decoder's input projection (``decoder/proj``
    matches its rule "proj"), which the port leaves whole."""
    from ssl_vit_video_analytics_tpu.parallel.ep import count_bank_sharded as jax_count_ep
    from ssl_vit_video_analytics_tpu.parallel.tp import count_sharded as jax_count_tp
    from ssl_vit_video_analytics_tpu_torch.models.mae import TinyVideoMAE, TinyViTMAE
    from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
    from ssl_vit_video_analytics_tpu_torch.parallel.ep import count_bank_sharded
    from ssl_vit_video_analytics_tpu_torch.parallel.tp import count_sharded

    dec = {"decoder_embed_dim": 24, "decoder_depth": 2, "decoder_num_heads": 6}
    heads = (1, 2, 4, 4)

    def jax_params(model, *shapes):
        return jax.eval_shape(lambda k: model.init(k, *(jnp.zeros(s, d) for s, d in shapes)),
                              jax.random.key(0))["params"]

    pix = ((B, T, S, S, 3), jnp.float32), ((B, T, L), bool)
    jmoe = jax_params(_jax_mae(heads, **MOE, **dec), *pix)
    port_moe = TinyVideoMAE(TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=heads,
                                    num_stages=3), clip_len=T, img_size=S, **dec, **MOE)
    assert count_bank_sharded(_cut_port(port_moe, {"data": 1, "expert": 2})) == \
        jax_count_ep(jmoe, _Lines(expert=2))

    jb = jax_params(_jax_mae(heads, **dec), *pix)
    port_b = TinyVideoMAE(TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=heads,
                                  num_stages=3), clip_len=T, img_size=S, **dec)
    assert count_sharded(_cut_port(port_b, {"data": 1, "model": tp})) == \
        jax_count_tp(jb, _Lines(model=tp))

    enc = JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=heads, use_checkpoint=False)
    jc = jax_params(JaxTinyViTMAE(encoder=enc, stage4_pool=2, decoder_dim=16, decoder_depth=1,
                                  decoder_num_heads=2),
                    ((B, 2, S, S, 3), jnp.float32), ((B, 8), bool))
    port_c = TinyViTMAE(TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=heads),
                        stage4_pool=2, decoder_dim=16, decoder_depth=1, decoder_num_heads=2)
    n_sh, n_tot = count_sharded(_cut_port(port_c, {"data": 1, "model": tp}))
    j_sh, j_tot = jax_count_tp(jc, _Lines(model=tp))
    assert (n_sh, n_tot) == (j_sh - 1, j_tot)
    assert hasattr(port_c.decoder.blocks.blocks[0].attn.qkv.weight, "shard")
    assert not hasattr(port_c.decoder.proj.weight, "shard")
