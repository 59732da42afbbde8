"""Token and frame masks for the SSL pipelines (counterpart of the JAX
package's ``data/masking.py``).

Every mask is drawn on the device from an explicit ``torch.Generator``: draw
per-token uniform noise, mask the ``num_mask`` largest. That is the JAX
package's selection; the numbers differ from ``jax.random``'s, so tests
inject the JAX mask where values matter. Counts round as the JAX package
does: Python's ``round`` (half to even) of ``n * ratio``, at least 1 where
the JAX function says so.

Convention: ``True = masked`` (same as the reference).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch


def get_mask_ratio(epoch: int, schedule: List[Dict[str, Any]] | None, default: float) -> float:
    """Epoch-indexed mask-ratio schedule (ref: src/mae/masking.py:9-18).

    ``schedule`` is a list of {start, end, value} segments, start <= epoch < end.
    """
    if not schedule:
        return float(default)
    for seg in schedule:
        s = int(seg.get("start", 1))
        e = int(seg.get("end", 10 ** 9))
        v = float(seg.get("value", default))
        if s <= epoch < e:
            return v
    return float(default)


def _topk_mask(generator: torch.Generator, batch: int, n: int, num_mask: int,
               device: torch.device | None = None) -> torch.Tensor:
    """``[batch, n]`` bool with exactly ``num_mask`` True per row, uniformly
    at random."""
    noise = torch.rand(batch, n, generator=generator, device=generator.device)
    order = torch.argsort(noise, dim=-1, descending=True)
    ranks = torch.argsort(order, dim=-1)
    return (ranks < num_mask).to(device or generator.device)


def random_token_mask(generator: torch.Generator, B: int, T: int, tokens_per_frame: int,
                      mask_ratio: float, device: torch.device | None = None) -> torch.Tensor:
    """``[B, T*P]`` bool; exactly ``max(1, round(N*ratio))`` masked per sample."""
    N = T * tokens_per_frame
    return _topk_mask(generator, B, N, max(1, int(round(N * mask_ratio))), device)


def tube_token_mask(generator: torch.Generator, B: int, T: int, tokens_per_frame: int,
                    mask_ratio: float, device: torch.device | None = None) -> torch.Tensor:
    """``[B, T*P]`` bool; spatial positions chosen once, repeated on every
    frame (frame-major: token ``n = t*P + p``; ref: src/mae/masking.py:45-55)."""
    P = tokens_per_frame
    spatial = _topk_mask(generator, B, P, max(1, int(round(P * mask_ratio))), device)
    return spatial.repeat(1, T)


def make_token_mask(generator: torch.Generator, B: int, T: int, tokens_per_frame: int,
                    mask_ratio: float, mode: str,
                    device: torch.device | None = None) -> torch.Tensor:
    """Dispatch on mode in {random, tube} (ref: src/mae/masking.py:21-57)."""
    if mode == "random":
        return random_token_mask(generator, B, T, tokens_per_frame, mask_ratio, device)
    if mode == "tube":
        return tube_token_mask(generator, B, T, tokens_per_frame, mask_ratio, device)
    raise ValueError(f"Unknown mask_mode: {mode}")


def get_tube_mask(generator: torch.Generator, batch_size: int, num_frames: int,
                  num_patches: int, mask_ratio: float,
                  device: torch.device | None = None) -> torch.Tensor:
    """``[B, T, L]`` bool tube mask with ``int(ratio*L)`` masked patches per
    sample, the same patches on every frame (pipeline-B semantics, ref:
    src/datasets/mae_loader.py:80-90: floor, not round)."""
    num_mask = int(mask_ratio * num_patches)
    spatial = _topk_mask(generator, batch_size, num_patches, num_mask, device)
    return spatial[:, None, :].expand(batch_size, num_frames, num_patches)


def frame_mask(generator: torch.Generator, B: int, T: int, mask_ratio: float,
               device: torch.device | None = None) -> torch.Tensor:
    """``[B, T]`` bool frame-level mask for pipeline A's masked feature
    modeling, ``max(1, round(T*ratio))`` frames per clip (ref:
    src/train_ssl.py:41-47)."""
    return _topk_mask(generator, B, T, max(1, int(round(T * mask_ratio))), device)


def count_masked(mask: torch.Tensor) -> int:
    return int(mask.sum())


def count_visible(mask: torch.Tensor) -> int:
    return int((~mask).sum())
