"""``b_pretrain.moe``'s comparison at a size the CPU holds: its limits lie
between their readings, a sound run is correct, and the control (the MoE
reference with float8 operands in the program's place) and each routing
fault, planted under the timed path of a whole run, fail them; the MoE
reference and the program share their state dict's names and shapes.

The toy cell (``toy.cell``) routes 2 frames of 16 tokens a clip in groups
of 32 tokens (the configuration's 392 divides no toy clip)."""
import json
import os

import pytest
import torch

import toy
from h100_bench import calibrate_moe, harness, inputs
from h100_bench.paths import pixel_mae_moe_train as moe_path
from h100_bench.reference import tinyvit_mae_moe as RM
from h100_bench.reference.common import Precision
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae

torch.set_num_threads(2)  # test workers share the host

WORKLOAD = "b_pretrain.moe"


def _cell():
    cell = toy.cell(WORKLOAD)
    cell.cfg["model"]["decoder_moe_group_size"] = 32
    return cell


def test_each_moe_limit_lies_between_its_readings():
    """As for the other cells: above the highest sound reading, below the
    lowest of the control or a fault, more room above the lower (in ratio)."""
    with open(os.path.join(harness.HERE, "limits", f"{WORKLOAD}.json")) as f:
        entries = json.load(f)
    assert set(entries) == set(moe_path.CHECKS)
    for name, e in entries.items():
        lo, limit, hi = e["lower"], e["limit"], e["upper"]
        assert 0 < lo < limit < hi and limit / lo >= hi / limit, (name, e)


def _correct(cell) -> tuple[bool, dict]:
    res = harness.run_cell(cell)
    line = harness.result_line(cell, res)
    return line["correct"], line["checks"]


def test_a_sound_moe_run_is_correct():
    ok, checks = _correct(_cell())
    assert ok, checks
    assert checks["route_differ"]["value"] == 0.0  # fp32 on both sides here


def test_the_moe_control_fails():
    cell = _cell()
    device = torch.device("cpu")
    prog = moe_path.Program(cell, device)
    rec = moe_path.checked_steps(
        prog, torch.Generator().manual_seed(inputs.stream_seed(cell.seed, 3)))
    args = (prog.cfg, rec, prog.weights0, prog.steps_per_epoch, device)
    ref = moe_path.reference_follow(*args)
    ctl = moe_path.reference_follow(*args, Precision("fp8"))
    readings = moe_path.compare(ctl, ref, prog.weights0, prog.accum)
    ok, checks = harness.judge({k: readings[k] for k in moe_path.CHECKS}, cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", ["no_capacity", "no_gate"])
def test_a_routing_fault_fails(fault, monkeypatch):
    orig = moe_path.Program.__init__

    def planted(self, *a, **k):
        orig(self, *a, **k)
        calibrate_moe.plant(self, fault)

    monkeypatch.setattr(moe_path.Program, "__init__", planted)
    ok, checks = _correct(_cell())
    assert not ok, checks
    failed = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert failed & {"route_differ", "grad_gap", "grad_median_gap"}, checks


def test_the_moe_state_dicts_share_names_and_shapes():
    cfg = _cell().cfg
    with torch.device("meta"):
        ref = RM.TinyVideoMAE(cfg)
        prog = train_ssl_mae.build_model(cfg, torch.float32)
    assert ({k: tuple(v.shape) for k, v in ref.state_dict().items()}
            == {k: tuple(v.shape) for k, v in prog.state_dict().items()})
    assert any(k.endswith("mlp.w1") for k in ref.state_dict())


def test_the_run_stops_at_once_without_the_moe_counters(monkeypatch):
    from ssl_vit_video_analytics_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "counters", lambda: {"host_syncs": 0})
    with pytest.raises(SystemExit, match="no MoE counters"):
        harness.run_cell(_cell())
