"""The port's resolution of the multi-device knobs over W ranks against the
JAX package's ``setup_parallelism`` / ``setup_data_parallel`` over W
devices (``jax.device_count`` patched to W on the 8-device CPU mesh), with
no process spawned: the same mesh axis and size, the same ``[INFO]`` and
``[WARN]`` lines (the mesh's repr aside; one extra port line on one device
where JAX is silent), and a ``NotImplementedError`` naming ROADMAP item 15c
wherever JAX would build a tensor-, pipeline- or expert-parallel mesh.
Also the mesh helpers that cut a global batch and its draws.
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
MODEL_AXES = {"model", "pipe", "expert"}


def _lines(lines):
    """Log lines with the mesh's repr cut off."""
    return [re.sub(r"(devices): .*$", r"\1: <mesh>", ln) for ln in lines]


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
    axes = set() if par.mesh is None else set(par.mesh.axis_names)
    if axes & MODEL_AXES or par.pp_mesh is not None:
        assert world > 1
        with pytest.raises(NotImplementedError, match="ROADMAP item 15c"):
            common.resolve_parallelism(cfg, batch, world, port_lines.append, allow_pp)
        # the warnings JAX logged before it built the mesh
        assert _lines(port_lines) == _lines(jax_lines)[:len(port_lines)]
        return
    axis, n, sp_on = common.resolve_parallelism(cfg, batch, world, port_lines.append,
                                                allow_pp)
    assert sp_on == par.sp_on
    assert (None if axis is None else {axis: n}) == (
        None if par.mesh is None else dict(par.mesh.shape))
    extra = [ln for ln in port_lines if common.ONE_DEVICE in ln]
    assert _lines([ln for ln in port_lines if common.ONE_DEVICE not in ln]) == _lines(jax_lines)
    assert not extra or world == 1

    # the data-parallel half alone (pipeline A, the finetune)
    jax_lines, port_lines = [], []
    mesh, _, _ = jcommon.setup_data_parallel(cfg, batch, jax_lines.append)
    n = common.resolve_data_parallel(cfg, batch, world, port_lines.append)
    assert n == (1 if mesh is None else mesh.shape["data"])
    assert _lines([ln for ln in port_lines if common.ONE_DEVICE not in ln]) == _lines(jax_lines)


@pytest.mark.parametrize("world", [2, 8])
def test_model_sharding_refusals_name_the_knob_and_the_way_out(world):
    with pytest.raises(NotImplementedError, match=r"--set device.expert_parallel=1 runs "
                                                  r"the MoE decoder data-parallel"):
        common.resolve_parallelism(_yaml("ssl_mae_moe"), 40, world, lambda _: None, True)
    with pytest.raises(NotImplementedError, match="device.model_parallel=4"):
        common.resolve_parallelism({"device": {"model_parallel": 4}}, 8, world,
                                   lambda _: None)
    with pytest.raises(NotImplementedError, match="device.pipeline_parallel=2"):
        common.resolve_parallelism({"device": {"pipeline_parallel": 2}}, 8, world,
                                   lambda _: None, True)
    # a model-sharding knob JAX ignores stays ignored: pipeline C's
    axis, n, _ = common.resolve_parallelism({"device": {"pipeline_parallel": 2}}, 8, world,
                                            lambda _: None, False)
    assert (axis, n) == ("data", world)


def test_one_device_runtime_needs_no_process_group():
    """Without a launcher nothing is set up: no group, no mesh."""
    assert not pmesh.launched()
    assert pmesh.world_size() == 1 and pmesh.rank() == 0 and pmesh.is_main()
    par = common.setup_parallelism({"model": {"sequence_parallel": True}}, 8, lambda _: None)
    assert par == common.ParallelRuntime(None, True) and par.member
    assert common.setup_data_parallel({"device": {"data_parallel": 4}}, 8, lambda _: None) \
        is None


def _mesh(axis, size, index):
    return pmesh.Mesh(axis, size, index, None)


def test_mesh_blocks_and_batch_parts():
    m = _mesh("data", 4, 2)
    assert m.block(8) == slice(4, 6) and m.batch_part(8, 16) == (slice(4, 6), slice(None))
    assert _mesh("seq", 4, 1).batch_part(8, 16) == (slice(None), slice(4, 8))
    assert repr(m) == "Mesh('data': 4)" and m.member and not _mesh("data", 2, -1).member
    with pytest.raises(ValueError, match="do not divide"):
        m.block(6)
    with pytest.raises(ValueError, match="one mesh axis"):
        pmesh.make_mesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        pmesh.make_mesh({"pipe": 2})


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
