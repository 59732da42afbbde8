"""Metrics: top-k accuracy, prediction entropy, the privacy exposure rate,
best tracking, the epoch-summary line, min-max normalization, and
throughput accounting for pipeline B (the JAX package's
``utils/metrics.py``): analytic train-step FLOPs per clip from the model
config, and the model FLOPs utilization against one H100 SXM's dense bf16
peak, where the JAX package divides by a TPU v5e's.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5)) -> dict:
    """Fraction of samples whose label is in the top-k logits, for each k
    (k clamped to the class count). logits ``[B, C]``; labels ``[B]`` int.
    Returns ``{f"top{k}": fp32 scalar on logits' device}``."""
    C = logits.shape[-1]
    maxk = min(max(ks), C)
    correct = logits.topk(maxk, dim=-1).indices == labels[:, None].long()  # [B, maxk]
    return {f"top{k}": correct[:, :min(k, C)].any(dim=1).float().mean() for k in ks}


def prediction_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean Shannon entropy of softmax predictions, an fp32 scalar on the
    logits' device (ref: src/privacy/metrics_privacy.py:5-8)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-(logp.exp() * logp).sum(dim=-1)).mean()


def privacy_exposure_rate(before: float, after: float) -> float:
    """PER = after / max(before, 1e-6) (ref: src/privacy/metrics_privacy.py:11-12)."""
    return after / max(before, 1e-6)


def update_best(best: Mapping | None, metrics: Mapping, key: str,
                mode: str = "max") -> tuple[dict, bool]:
    """Track the best epoch by one metric (ref: src/mae/metrics.py:7-16).

    Returns (new_best, improved).
    """
    cur = float(metrics[key])
    if best is None or key not in best:
        return dict(metrics), True
    prev = float(best[key])
    improved = cur > prev if mode == "max" else cur < prev
    return (dict(metrics) if improved else dict(best)), improved


def format_metrics(metrics: Mapping, precision: int = 4) -> str:
    """"k1=v1 k2=v2" epoch-summary line (ref: src/mae/metrics.py:19-27)."""
    parts = []
    for k, v in metrics.items():
        try:
            parts.append(f"{k}={float(v):.{precision}f}")
        except (TypeError, ValueError):
            parts.append(f"{k}={v}")
    return " ".join(parts)


def minmax_norm(values: Sequence[float]) -> list[float]:
    """Min-max normalize to [0,1]; constant input -> zeros (ref: src/utils.py:60-71)."""
    vals = [float(v) for v in values]
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        return [0.0 for _ in vals]
    return [(v - lo) / (hi - lo) for v in vals]


def _mbconv_flops(c_in: int, c_out: int, r_in: int, r_out: int,
                  expand: int = 4) -> float:
    """Fwd FLOPs (2*MAC) of one TinyViT MBConv (expand->dw->SE->project)."""
    mid = c_in * expand
    return (2.0 * r_in * r_in * c_in * mid          # 1x1 expand
            + 2.0 * r_out * r_out * mid * 9          # 3x3 depthwise
            + 2.0 * 2 * mid * (mid // 4)             # SE (2 dense, per image)
            + 2.0 * r_out * r_out * mid * c_out)     # 1x1 project


def _tblock_flops(tokens: int, dim: int) -> float:
    """Fwd FLOPs of one full-attention transformer block (mlp_ratio 4)."""
    return 24.0 * tokens * dim * dim + 4.0 * tokens * tokens * dim


def pipeline_b_flops_per_clip(clip_len: int, image_size: int = 112,
                              embed_dims=(96, 192, 384, 576),
                              depths=(2, 2, 6, 2),
                              decoder_embed_dim: int = 384,
                              decoder_depth: int = 4,
                              patch_size: int = 8) -> float:
    """Analytic train-step FLOPs/clip for pipeline B, derived from the actual
    model config (TinyViT stage_limit=3 encoder per frame + full-sequence
    decoder per clip), x3 for fwd+bwd. For the default tiny_vit_21m@112
    config this evaluates to ~8.8 GF/frame fwd + ~106 GF decoder fwd (the
    previously hardcoded constants)."""
    d0, d1, d2 = embed_dims[0], embed_dims[1], embed_dims[2]
    r0, r1, r2 = image_size // 2, image_size // 4, image_size // 8
    # per-frame encoder (stages 0-2)
    f = 2.0 * r0 * r0 * (d0 // 2) * 27          # stem conv1 (3->d0/2, 3x3 s2)
    f += 2.0 * r0 * r0 * d0 * (d0 // 2) * 9     # stem conv2
    f += depths[0] * _mbconv_flops(d0, d0, r0, r0)
    f += _mbconv_flops(d0, d1, r0, r1)          # stage-1 downsample
    f += depths[1] * _tblock_flops(r1 * r1, d1)
    f += _mbconv_flops(d1, d2, r1, r2)          # stage-2 downsample
    f += depths[2] * _tblock_flops(r2 * r2, d2)
    # per-clip decoder over the full T*(S/8)^2 token sequence
    n_tok = clip_len * r2 * r2
    dd = decoder_embed_dim
    dec = 2.0 * n_tok * d2 * dd                 # enc->dec embed
    dec += decoder_depth * _tblock_flops(n_tok, dd)
    dec += 2.0 * n_tok * dd * (patch_size * patch_size * 3)  # pixel head
    return 3.0 * (f * clip_len + dec)


# NVIDIA's data sheet, H100 SXM: dense bf16 tensor-core FLOP/s at 700 W
H100_SXM_PEAK_BF16_FLOPS = 989e12


def pipeline_b_mfu(clips_per_sec: float, clip_len: int, image_size: int = 112,
                   cards: int = 1, **model_kwargs) -> float:
    """Model FLOPs utilization of the pipeline-B train step on ``cards``
    H100 SXMs (``clips_per_sec`` over all of them; JAX divides by one
    chip's peak whatever the mesh). ``model_kwargs`` go to
    :func:`pipeline_b_flops_per_clip`, so the count follows non-default
    widths and depths. (The MoE decoder's dispatch and combine are not
    model FLOPs: the count is the dense model's.)"""
    return (clips_per_sec * pipeline_b_flops_per_clip(clip_len, image_size, **model_kwargs)
            / (cards * H100_SXM_PEAK_BF16_FLOPS))


def pipeline_b_model_kwargs(cfg: dict) -> dict:
    """Extract the FLOPs-relevant model shape from a pipeline-B config."""
    m = cfg.get("model", {})
    return {
        "embed_dims": tuple(m.get("embed_dims", (96, 192, 384, 576))),
        "decoder_embed_dim": int(m.get("decoder_embed_dim", 384)),
        "decoder_depth": int(m.get("decoder_depth", 4)),
    }
