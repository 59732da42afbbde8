"""The comparison that decides ``correct``, at a size the CPU holds: a
sound run passes each cell's limits; the control (the reference with
float8 operands in the program's place) and each fault the cell can have,
planted under the timed path of a whole run past the harness's look for a
card, fail them."""
import json
import os

import pytest
import torch

import toy
from h100_bench import calibrate, harness, inputs
from h100_bench.paths import early_exit_serve as serve_path
from h100_bench.paths import pixel_mae_train as train_path
from h100_bench.reference.common import Precision

TRAIN_CELLS = ["b_pretrain.clip16", "b_pretrain.clip64"]


@pytest.mark.parametrize("workload", TRAIN_CELLS + ["serve_ee.b8"])
def test_each_limit_lies_between_its_readings(workload):
    """A limit lies above the highest reading of sound runs and below the
    lowest of the control or a fault, with more room above the lower (in
    ratio) than below the upper; an exact comparison's limit is 0."""
    with open(os.path.join(harness.HERE, "limits", f"{workload}.json")) as f:
        entries = json.load(f)
    for name, e in entries.items():
        lo, limit, hi = e["lower"], e["limit"], e["upper"]
        assert limit < hi, (name, e)
        if limit == 0:
            assert lo == 0, (name, e)
        else:
            assert lo < limit and limit / lo >= hi / limit, (name, e)


def _correct(cell) -> tuple[bool, dict]:
    res = harness.run_cell(cell)
    line = harness.result_line(cell, res)
    return line["correct"], line["checks"]


@pytest.mark.parametrize("workload", TRAIN_CELLS + ["serve_ee.b8"])
def test_a_sound_run_is_correct(workload):
    ok, checks = _correct(toy.cell(workload))
    assert ok, checks


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_the_training_control_fails(workload):
    cell = toy.cell(workload)
    device = torch.device("cpu")
    prog = train_path.Program(cell, device)
    rec = train_path.checked_steps(
        prog, torch.Generator().manual_seed(inputs.stream_seed(cell.seed, 3)))
    ref = train_path.reference_follow(prog.cfg, rec, prog.weights0, prog.steps_per_epoch, device)
    ctl = train_path.reference_follow(prog.cfg, rec, prog.weights0, prog.steps_per_epoch, device,
                                      Precision("fp8"))
    readings = train_path.compare(ctl, ref, prog.weights0, prog.accum)
    ok, checks = harness.judge({k: readings[k] for k in train_path.CHECKS}, cell.limits)
    assert not ok, checks


def test_the_serving_control_fails():
    cell = toy.cell("serve_ee.b8")
    prog = serve_path.Program(cell, torch.device("cpu"))
    ids = list(range(prog.batches_per_pass))
    args = (prog.cfg, prog.split, ids, prog.threshold, prog.ee, prog.weights0, prog.B, "cpu")
    ref_logits, ref_used = serve_path.reference_serve(*args)
    c_logits, c_used = serve_path.reference_serve(*args, Precision("fp8"))
    ok, checks = harness.judge(serve_path.compare(c_logits, c_used, ref_logits, ref_used),
                               cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_a_step_that_leaves_the_state_unchanged_fails(workload, monkeypatch):
    from ssl_vit_video_analytics_tpu_torch.train import mae_engine

    def unchanged(state, grads, group=None, shards=None):
        state.step += 1
        return False

    monkeypatch.setattr(mae_engine, "apply_updates", unchanged)
    ok, checks = _correct(toy.cell(workload))
    assert not ok and checks["change_gap"]["value"] > checks["change_gap"]["limit"], checks


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_half_of_the_batch_left_out_fails(workload, monkeypatch):
    orig = train_path.Program.__init__

    def planted(self, *a, **k):
        orig(self, *a, **k)
        calibrate.half_batch(self)

    monkeypatch.setattr(train_path.Program, "__init__", planted)
    ok, checks = _correct(toy.cell(workload))
    assert not ok, checks


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    from ssl_vit_video_analytics_tpu_torch.entry import run_dynamic

    orig = run_dynamic.streaming_early_exit

    def altered(*a, **k):
        logits, stats = orig(*a, **k)
        logits = logits.clone()
        logits[0, 0] += 0.5
        return logits, stats

    monkeypatch.setattr(run_dynamic, "streaming_early_exit", altered)
    ok, checks = _correct(toy.cell("serve_ee.b8"))
    assert not ok and checks["logit_gap"]["value"] > checks["logit_gap"]["limit"], checks


def test_a_frame_count_altered_fails(monkeypatch):
    from ssl_vit_video_analytics_tpu_torch.entry import run_dynamic
    from ssl_vit_video_analytics_tpu_torch.models.dynamic import EarlyExitStats

    orig = run_dynamic.streaming_early_exit

    def altered(*a, **k):
        logits, stats = orig(*a, **k)
        used = stats.used_frames.clone()
        used[-1] -= 1
        return logits, EarlyExitStats(used, stats.final_conf)

    monkeypatch.setattr(run_dynamic, "streaming_early_exit", altered)
    ok, checks = _correct(toy.cell("serve_ee.b8"))
    assert not ok and checks["frames_differ"]["value"] > 0, checks
