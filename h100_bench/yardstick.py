"""The benchmark's frozen arithmetic: the H100's peaks, the least time of an
attention call, pipeline B's model FLOPs a clip, the percentile of a
window's latencies, and the comparisons that decide ``correct``. Copied from the program where it had them (the peaks
and ``bound_ms`` of its ``scripts/__init__.py``, ``attention_bound`` of its
``chip_smoke.py``, ``pipeline_b_flops_per_clip`` of its
``utils/metrics.py``), so that a change to the program cannot move the
yardstick."""
from __future__ import annotations

import math
import statistics

import torch

# NVIDIA's data sheet, H100 SXM at 700 W: dense rates, HBM3 bandwidth
BF16_TENSOR_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(bytes_moved: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    peak rate, in seconds, and which of the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


def attention_bound(B: int, Lq: int, Lk: int, H: int, d: int, dtype: torch.dtype,
                    backward: bool) -> tuple[float, str]:
    """Least seconds of one attention call: 4*B*H*Lq*Lk*d FLOPs forward
    (10*... backward) at the bf16 tensor-core or the fp32 peak, or every
    input read and output written once (forward: q, k, v in, out and the
    fp32 log-sum-exp out; backward: q, k, v, out, dout and the lse in, dq,
    dk, dv out), whichever is longer."""
    row = B * H * d * (2 if dtype in (torch.bfloat16, torch.float16) else 4)
    if backward:
        flops, moved = 10 * B * H * Lq * Lk * d, (4 * Lq + 4 * Lk) * row
    else:
        flops, moved = 4 * B * H * Lq * Lk * d, (2 * Lq + 2 * Lk) * row
    peak = BF16_TENSOR_FLOP_PER_S if dtype in (torch.bfloat16, torch.float16) else FP32_FLOP_PER_S
    return bound_s(moved + B * Lq * H * 4, flops, peak)


def _mbconv_flops(c_in: int, c_out: int, r_in: int, r_out: int, expand: int = 4) -> float:
    """Forward FLOPs (2 per multiply-add) of one MBConv: 1x1 expand, 3x3
    depthwise, squeeze-excite (two dense layers on the pooled vector),
    1x1 project."""
    mid = c_in * expand
    return (2.0 * r_in * r_in * c_in * mid
            + 2.0 * r_out * r_out * mid * 9
            + 2.0 * 2 * mid * (mid // 4)
            + 2.0 * r_out * r_out * mid * c_out)


def _tblock_flops(tokens: int, dim: int) -> float:
    """Forward FLOPs of one full-attention transformer block (MLP x4)."""
    return 24.0 * tokens * dim * dim + 4.0 * tokens * tokens * dim


def pipeline_b_forward_flops_per_clip(clip_len: int, image_size: int = 112,
                                      embed_dims=(96, 192, 384, 576), depths=(2, 2, 6, 2),
                                      decoder_embed_dim: int = 384, decoder_depth: int = 4,
                                      patch_size: int = 8) -> float:
    """Forward model FLOPs of one pipeline-B clip: TinyViT stages 0-2 on
    every frame, then the decoder over all T*(S/8)^2 tokens and the pixel
    head."""
    d0, d1, d2 = embed_dims[0], embed_dims[1], embed_dims[2]
    r0, r1, r2 = image_size // 2, image_size // 4, image_size // 8
    f = 2.0 * r0 * r0 * (d0 // 2) * 27
    f += 2.0 * r0 * r0 * d0 * (d0 // 2) * 9
    f += depths[0] * _mbconv_flops(d0, d0, r0, r0)
    f += _mbconv_flops(d0, d1, r0, r1)
    f += depths[1] * _tblock_flops(r1 * r1, d1)
    f += _mbconv_flops(d1, d2, r1, r2)
    f += depths[2] * _tblock_flops(r2 * r2, d2)
    n_tok = clip_len * r2 * r2
    dd = decoder_embed_dim
    dec = 2.0 * n_tok * d2 * dd
    dec += decoder_depth * _tblock_flops(n_tok, dd)
    dec += 2.0 * n_tok * dd * (patch_size * patch_size * 3)
    return f * clip_len + dec


def pipeline_b_flops_per_clip(clip_len: int, **kwargs) -> float:
    """Train-step model FLOPs of one clip: forward and backward, three times
    the forward; recomputation is not counted."""
    return 3.0 * pipeline_b_forward_flops_per_clip(clip_len, **kwargs)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value that at least q% of them do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf, the gap between two norms: ``|‖prog‖ - ‖ref‖|`` over the
    larger of the reference leaf's norm and the median leaf's (some leaves'
    gradients are all but zero). ``prog``, ``ref``: name -> tensor; a leaf
    missing from ``prog`` has norm 0; a gap that is not finite is inf."""
    pn = {n: float(prog[n].double().norm()) if n in prog else 0.0 for n in ref}
    rn = {n: float(ref[n].double().norm()) for n in ref}
    median = statistics.median(rn.values())
    out = {}
    for n in ref:
        gap = abs(pn[n] - rn[n]) / max(rn[n], median, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def norm_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """The worst leaf's gap (:func:`leaf_gaps`) and the leaf it is on."""
    gaps = leaf_gaps(prog, ref)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def median_gap(prog: dict, ref: dict) -> float:
    """The median leaf's gap (:func:`leaf_gaps`)."""
    return statistics.median(leaf_gaps(prog, ref).values())


def moving_elements(first_grad: dict, floor: float = 1e-3) -> dict:
    """Per leaf, the elements whose reference gradient is at least
    ``floor`` of the median leaf's root-mean-square gradient; leaves with
    none are left out. The others (a fused qkv bias's key third, under
    softmax) have a gradient that is round-off, which Adam turns into a
    step as large as any."""
    rms = [float(g.double().norm()) / math.sqrt(max(g.numel(), 1)) for g in first_grad.values()]
    cut = floor * statistics.median(rms)
    out = {}
    for n, g in first_grad.items():
        keep = g.abs() >= cut
        if bool(keep.any()):
            out[n] = keep
    return out


def relative_gap(prog, ref) -> float:
    """``max |prog - ref| / |ref|`` over paired scalars."""
    worst = 0.0
    for a, b in zip(prog, ref, strict=True):
        gap = abs(a - b) / max(abs(b), 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst
