"""The port's resolution of the multi-device knobs over W ranks against the
JAX package's ``setup_parallelism`` / ``setup_data_parallel`` over W
devices (``jax.device_count`` patched to W on the 8-device CPU mesh), with
no process spawned: the same mesh, every axis and size (data, seq, data x
expert, pipe, data x model), the same microbatches, and the same ``[INFO]``
and ``[WARN]`` lines, the mesh's repr included (JAX's ``axis_types`` aside;
the TP line names the port's attention where JAX's names XLA's; one extra
port line on one device where JAX is silent). Also the mesh helpers that
cut a global batch and its draws.
"""
import os
import re

import jax
import pytest
import torch

from ssl_vit_video_analytics_tpu.entry import common as jcommon
from ssl_vit_video_analytics_tpu.ops import attention as jattention
from ssl_vit_video_analytics_tpu.parallel import ep as jep
from ssl_vit_video_analytics_tpu_torch.entry import common
from ssl_vit_video_analytics_tpu_torch.parallel import mesh as pmesh
from ssl_vit_video_analytics_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "configs", "base.yaml")


def _yaml(name: str) -> dict:
    return load_config(os.path.join(REPO, "configs", f"{name}.yaml"), base=BASE)


# (config, batch size, allow_pp): the one-device knob cases, then an
# explicit data_parallel: true (True == 1: off in JAX) and a batch that no
# rank count above 1 divides
CASES = {
    "ssl_mae_moe": (lambda: _yaml("ssl_mae_moe"), 40, True),
    "ssl_mae_longclip": (lambda: _yaml("ssl_mae_longclip"), 8, True),
    "ep_moe": (lambda: {"device": {"expert_parallel": 2},
                        "model": {"decoder_moe_experts": 4}}, 8, True),
    "ep_dense": (lambda: {"device": {"expert_parallel": 2}}, 8, True),
    "ep_pipeline_c": (lambda: {"device": {"expert_parallel": 2},
                               "model": {"decoder_moe_experts": 4}}, 8, False),
    "ep_with_sp": (lambda: {"device": {"expert_parallel": 2},
                            "model": {"decoder_moe_experts": 4, "sequence_parallel": True}},
                   8, True),
    "pp": (lambda: {"device": {"pipeline_parallel": 2}}, 8, True),
    "pp_pipeline_c": (lambda: {"device": {"pipeline_parallel": 2}}, 8, False),
    "pp_with_tp": (lambda: {"device": {"pipeline_parallel": 2, "model_parallel": 2}}, 8, True),
    "sp_device": (lambda: {"device": {"sequence_parallel": True}}, 8, False),
    "tp": (lambda: {"device": {"model_parallel": 4}}, 8, True),
    "dp_n": (lambda: {"device": {"data_parallel": 2}}, 8, True),
    "dp_auto": (lambda: {"device": {"data_parallel": "auto"}}, 8, True),
    "dp_off": (lambda: {"device": {"data_parallel": False}}, 8, False),
    "dp_true": (lambda: {"device": {"data_parallel": True}}, 8, False),
    "odd_batch": (lambda: {"device": {"data_parallel": "auto"}}, 7, True),
    "none": (lambda: {}, 12, True),
}
WORLDS = (1, 2, 3, 4, 8)


def _lines(lines):
    """Log lines in the port's words: JAX's mesh repr without its
    ``axis_types``, and the TP line's attention named as the port runs it."""
    lines = [re.sub(r", axis_types=\([^)]*\)\)", ")", ln) for ln in lines]
    return [ln.replace("(attention impl -> xla)", common.TP_ATTENTION) for ln in lines]


@pytest.fixture
def jax_world(monkeypatch):
    """``jax.device_count`` patched per call; the JAX package's attention
    and expert-parallel registries restored after the test."""
    monkeypatch.setattr(jattention, "_DEFAULT_IMPL", jattention._DEFAULT_IMPL)
    monkeypatch.setattr(jattention, "_SP_MESH", jattention._SP_MESH)
    monkeypatch.setattr(jattention, "_SP_AXIS", jattention._SP_AXIS)
    monkeypatch.setattr(jep, "_EP_MESH", jep._EP_MESH)
    monkeypatch.setattr(jep, "_EP_AXIS", jep._EP_AXIS)

    def use(world):
        monkeypatch.setattr(jax, "device_count", lambda: world)
    return use


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_knob_resolution_matches_jax(case, world, jax_world):
    make, batch, allow_pp = CASES[case]
    cfg = make()
    jax_world(world)
    jax_lines, port_lines = [], []
    par = jcommon.setup_parallelism(cfg, batch, jax_lines.append, allow_pp=allow_pp)
    res = common.resolve_parallelism(cfg, batch, world, port_lines.append, allow_pp)
    assert res.sp_on == par.sp_on
    assert res.axes == (None if par.mesh is None else dict(par.mesh.shape))
    assert res.pp_microbatches == par.pp_microbatches
    assert (res.pp_microbatches is None) == (par.pp_mesh is None)
    extra = [ln for ln in port_lines if common.ONE_DEVICE in ln]
    assert [ln for ln in port_lines if common.ONE_DEVICE not in ln] == _lines(jax_lines)
    assert not extra or world == 1

    # the data-parallel half alone (pipeline A, the finetune)
    jax_lines, port_lines = [], []
    mesh, _, _ = jcommon.setup_data_parallel(cfg, batch, jax_lines.append)
    n = common.resolve_data_parallel(cfg, batch, world, port_lines.append)
    assert n == (1 if mesh is None else mesh.shape["data"])
    assert [ln for ln in port_lines if common.ONE_DEVICE not in ln] == _lines(jax_lines)


# the shipped MoE yaml, model_parallel: 4 on pipelines B and C, and
# pipeline_parallel: 2 with 2 and 4 microbatches
SHARDING = {
    "ssl_mae_moe": (lambda: _yaml("ssl_mae_moe"), 40, True),
    "tp4_b": (lambda: dict(_yaml("ssl_mae"), device={"model_parallel": 4}), 40, True),
    "tp4_c": (lambda: dict(_yaml("mae_train"), device={"model_parallel": 4}), 256, False),
    "pp2": (lambda: dict(_yaml("ssl_mae"), device={"pipeline_parallel": 2}), 40, True),
    "pp2_micro4": (lambda: dict(_yaml("ssl_mae"),
                                device={"pipeline_parallel": 2, "pp_microbatches": 4}), 40,
                   True),
}


@pytest.mark.parametrize("world", [2, 8])
def test_model_sharding_meshes_match_jax(world, jax_world):
    """The meshes of the shipped MoE yaml, of ``model_parallel: 4`` and of
    ``pipeline_parallel: 2`` over 2 and 8 ranks: JAX's, axis for axis,
    with JAX's log line (at 8: dp2 x ep4, dp2 x tp4, pipe 2)."""
    jax_world(world)
    want_8 = {"ssl_mae_moe": {"data": 2, "expert": 4}, "tp4_b": {"data": 2, "model": 4},
              "tp4_c": {"data": 2, "model": 4}, "pp2": {"pipe": 2}, "pp2_micro4": {"pipe": 2}}
    for name, (make, batch, allow_pp) in SHARDING.items():
        cfg, jax_lines, port_lines = make(), [], []
        par = jcommon.setup_parallelism(cfg, batch, jax_lines.append, allow_pp=allow_pp)
        res = common.resolve_parallelism(cfg, batch, world, port_lines.append, allow_pp)
        assert res.axes == dict(par.mesh.shape), name
        assert port_lines == _lines(jax_lines) and len(port_lines) == 1, name
        assert res.pp_microbatches == par.pp_microbatches
        if world == 8:
            assert res.axes == want_8[name], name
    # a microbatch count that does not divide the batch: JAX's error
    cfg = {"device": {"pipeline_parallel": 2, "pp_microbatches": 3}}
    with pytest.raises(ValueError, match="not divisible by pp_microbatches=3"):
        jcommon.setup_parallelism(cfg, 8, lambda _: None, allow_pp=True)
    with pytest.raises(ValueError, match="not divisible by pp_microbatches=3"):
        common.resolve_parallelism(cfg, 8, world, lambda _: None, True)
    # a model-sharding knob JAX ignores stays ignored: pipeline C's
    res = common.resolve_parallelism({"device": {"pipeline_parallel": 2}}, 8, world,
                                     lambda _: None, False)
    assert res.axes == {"data": world}


def test_one_device_runtime_needs_no_process_group():
    """Without a launcher nothing is set up: no group, no mesh."""
    assert not pmesh.launched()
    assert pmesh.world_size() == 1 and pmesh.rank() == 0 and pmesh.is_main()
    par = common.setup_parallelism({"model": {"sequence_parallel": True}}, 8, lambda _: None)
    assert par == common.ParallelRuntime(None, True) and par.member
    assert common.setup_data_parallel({"device": {"data_parallel": 4}}, 8, lambda _: None) \
        is None


def _mesh(axis, size, index):
    return pmesh.Mesh(((axis, size),), None if index < 0 else (index,))


def test_mesh_blocks_and_batch_parts():
    m = _mesh("data", 4, 2)
    assert m.block(8) == slice(4, 6) and m.batch_part(8, 16) == (slice(4, 6), slice(None))
    assert _mesh("seq", 4, 1).batch_part(8, 16) == (slice(None), slice(4, 8))
    assert repr(m) == "Mesh('data': 4)" and m.member and not _mesh("data", 2, -1).member
    with pytest.raises(ValueError, match="do not divide"):
        m.block(6)
    # two axes, laid out row-major: rank 6 of {data: 2, expert: 4} sits at
    # (1, 2); the batch splits over data alone, and not at all over pipe
    two = pmesh.Mesh((("data", 2), ("expert", 4)), (1, 2))
    assert repr(two) == "Mesh('data': 2, 'expert': 4)" and two.index() == 6
    assert (two.size(), two.size("expert"), two.index("data")) == (8, 4, 1)
    assert two.split_axis == "data" and two.model_axis == "expert"
    assert two.block(8) == slice(4, 8)
    pipe = _mesh("pipe", 4, 3)
    assert pipe.split_axis is None and pipe.block(8) == slice(0, 8)
    assert pmesh.shard_batch({"clip": torch.zeros(4, 2)}, pipe)["clip"].shape == (4, 2)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        pmesh.make_mesh({"time": 2})
    with pytest.raises(RuntimeError, match="initialized process group"):
        pmesh.make_mesh({"data": 2, "model": 2})


def test_shard_batch_and_global_draws_keep_this_ranks_part():
    B, T, L = 4, 6, 3
    clip = torch.arange(B * T).reshape(B, T)[..., None].expand(B, T, 5)
    batch = {"clip": clip, "label": torch.arange(B), "valid": torch.ones(B, dtype=torch.bool)}
    data, seq = _mesh("data", 2, 1), _mesh("seq", 3, 2)
    got = pmesh.shard_batch(batch, data)
    assert torch.equal(got["clip"], clip[2:]) and torch.equal(got["label"], batch["label"][2:])
    got = pmesh.shard_batch(batch, seq)
    assert torch.equal(got["clip"], clip[:, 4:]) and torch.equal(got["label"], batch["label"])
    assert pmesh.shard_batch(batch, None) is batch
    assert pmesh.global_clip_shape(data, 2, T) == (4, T, 0)
    assert pmesh.global_clip_shape(seq, B, 2) == (B, 6, 4)
    # a tube mask [B, T, L], a token mask [B, T*P], a per-clip draw [B]
    tube = torch.rand(B, T, L) < 0.5
    assert torch.equal(pmesh.local_part(tube, data, T), tube[2:])
    assert torch.equal(pmesh.local_part(tube, seq, T), tube[:, 4:])
    tokens = torch.arange(B * T * 2).reshape(B, T * 2)
    assert torch.equal(pmesh.local_part(tokens, seq, T), tokens[:, 8:])
    flip = torch.tensor([True, False, True, True])
    assert torch.equal(pmesh.local_part(flip, seq), flip)
    assert torch.equal(pmesh.local_part(flip, data), flip[2:])
    # stochastic-depth decisions: [B*T] in (clip, frame) order, nested
    keep = torch.arange(B * T).float()
    drop = [[None, keep], [(keep, keep + 1)]]
    got = pmesh.local_draws(drop, seq, B, T)
    assert got[0][0] is None and isinstance(got[1][0], tuple)
    assert torch.equal(got[0][1], keep.reshape(B, T)[:, 4:].reshape(-1))
    assert torch.equal(pmesh.local_draws(drop, data, B, T)[1][0][1],
                       (keep + 1).reshape(B, T)[2:].reshape(-1))
