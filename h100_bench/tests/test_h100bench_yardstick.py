"""The benchmark's frozen arithmetic."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import harness, yardstick
from h100_bench.reference import tinyvit_mae as RT


@pytest.mark.parametrize("clip_len", [16, 64])
def test_pipeline_b_forward_flops_equal_the_flop_counter(clip_len):
    """At configs/ssl_mae.yaml's widths, forward only: the counter's
    backward counts recomputation and the grouped conv's weight gradient
    as dense, which are not model FLOPs."""
    with open(os.path.join(harness.HERE, "configs", "tinyvit_videomae_b.json")) as f:
        cfg = json.load(f)["cfg"]
    cfg["dataset"]["clip_len"] = clip_len
    with torch.device("meta"):
        model = RT.TinyVideoMAE(cfg)
        clip = torch.zeros(1, clip_len, 112, 112, 3, dtype=torch.uint8)
        mask = torch.zeros(1, clip_len, 196, dtype=torch.bool)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(clip, mask, [[None] * 2, [None] * 2, [None] * 6])
    analytic = yardstick.pipeline_b_forward_flops_per_clip(clip_len)
    assert abs(counter.get_total_flops() - analytic) <= 1e-3 * analytic
    assert yardstick.pipeline_b_flops_per_clip(clip_len) == 3 * analytic


@pytest.mark.parametrize("shape, fwd_ms, bwd_ms", [
    ((4, 3136, 3136, 6, 64), 0.0611, 0.1527),       # mae_decoder
    ((8, 12544, 12544, 6, 64), 1.9550, 4.8876),     # longclip_decoder
])
def test_attention_bound_reproduces_the_kernel_table(shape, fwd_ms, bwd_ms):
    fwd, by_f = yardstick.attention_bound(*shape, torch.bfloat16, backward=False)
    bwd, by_b = yardstick.attention_bound(*shape, torch.bfloat16, backward=True)
    assert (round(fwd * 1e3, 4), by_f) == (fwd_ms, "ops")
    assert (round(bwd * 1e3, 4), by_b) == (bwd_ms, "ops")


def test_attention_bound_by_bytes_at_a_short_sequence():
    t, by = yardstick.attention_bound(128, 196, 196, 12, 32, torch.bfloat16, backward=False)
    assert by == "bytes" and round(t * 1e3, 4) == 0.0234  # tinyvit_stage2


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 95) == 95
    assert yardstick.percentile([3.0], 95) == 3.0
    assert yardstick.percentile([5, 1, 4, 2, 3], 95) == 5
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_norm_gap_takes_the_worst_leaf_against_the_median_leaf():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.full((4,), 1e-6)}
    prog = {"a": torch.ones(4) * 1.01, "b": torch.full((4,), 2.0), "c": torch.full((4,), 1e-3)}
    gap, at = yardstick.norm_gap(prog, ref)
    # c is all but zero: its gap is measured against the median leaf's norm
    assert at == "a" and abs(gap - 0.01) < 1e-6
    assert abs(yardstick.median_gap(prog, ref) - 0.000999) < 1e-6  # c, over the median norm
    assert yardstick.norm_gap({}, {"a": torch.ones(4)})[0] == 1.0


def test_relative_gap():
    assert yardstick.relative_gap([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)
    assert yardstick.relative_gap([float("nan")], [1.0]) == float("inf")


def test_moving_elements_leave_out_round_off_gradients():
    g = {"qkv.bias": torch.tensor([1e-2, -2e-2, 1e-12, -1e-12, 3e-2, 1e-2]),
         "w": torch.full((4,), 1e-2), "dead": torch.full((3,), 1e-13)}
    m = yardstick.moving_elements(g)
    assert set(m) == {"qkv.bias", "w"}
    assert m["qkv.bias"].tolist() == [True, True, False, False, True, True]
