"""On-device clip augmentation for supervised finetuning, opt-in
(counterpart of the JAX package's ``ops/augment.py``).

The reference's supervised path has no augmentation (resize and normalize
only), so ``training.augment`` is off by default. Per sample, shared across
the clip's T frames so that it stays coherent in time: a translation by
``(dy, dx)`` in ``[0, 2*max_shift]`` over an edge-padded frame, a
brightness shift ``U(-b, b)``, a contrast gain ``U(1-c, 1+c)`` around the
sample's per-channel mean over (T, H, W), and an optional horizontal flip
with p = 0.5 (off by default: a mirror flips motion, which can carry the
class). The draws come from an explicit generator, or are passed in as
:class:`AugmentDraws` (tests hand in JAX's).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class AugmentDraws(NamedTuple):
    """One batch's draws; a field is None where its augmentation is off."""

    offsets: torch.Tensor | None  # [B, 2] int, (dy, dx) in [0, 2*max_shift]
    delta: torch.Tensor | None    # [B] brightness shift
    gain: torch.Tensor | None     # [B] contrast gain
    flip: torch.Tensor | None     # [B] bool


def draw_augment(generator: torch.Generator, batch: int, *, max_shift: int = 8,
                 brightness: float = 0.2, contrast: float = 0.2,
                 hflip: bool = False) -> AugmentDraws:
    """The draws of :func:`augment_clip` for ``batch`` samples, fp32 on the
    generator's device."""
    dev = generator.device

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=dev)

    return AugmentDraws(
        offsets=(torch.randint(0, 2 * max_shift + 1, (batch, 2), generator=generator,
                               device=dev) if max_shift > 0 else None),
        delta=uniform(-brightness, brightness) if brightness > 0 else None,
        gain=uniform(1.0 - contrast, 1.0 + contrast) if contrast > 0 else None,
        flip=(torch.rand(batch, generator=generator, device=dev) < 0.5) if hflip else None)


def augment_clip(clip: torch.Tensor, generator: torch.Generator | None = None, *,
                 max_shift: int = 8, brightness: float = 0.2, contrast: float = 0.2,
                 hflip: bool = False, draws: AugmentDraws | None = None,
                 batch: int | None = None, rows: slice | None = None) -> torch.Tensor:
    """clip ``[B, T, H, W, C]`` float (after ``normalize_clip``) -> the same
    shape and dtype, augmented with ``draws`` or, without them, with draws
    from ``generator``. With ``batch`` and ``rows`` the clip is rows
    ``rows`` of a batch of ``batch`` clips (a ``data`` mesh's block): the
    draws are made for the whole batch and this call takes its rows'."""
    B, T, H, W, C = clip.shape
    if draws is None:
        draws = draw_augment(generator, batch or B, max_shift=max_shift,
                             brightness=brightness, contrast=contrast, hflip=hflip)
        if rows is not None:
            draws = AugmentDraws(*(None if d is None else d[rows] for d in draws))
    out = clip
    if max_shift > 0:
        # edge padding then a window at the offset = source indices clamped
        # to the frame
        off = draws.offsets.to(clip.device).long()
        rows = (off[:, :1] + torch.arange(H, device=clip.device) - max_shift).clamp(0, H - 1)
        cols = (off[:, 1:] + torch.arange(W, device=clip.device) - max_shift).clamp(0, W - 1)
        b = torch.arange(B, device=clip.device)[:, None, None]
        out = out[b, :, rows[:, :, None], cols[:, None, :]].permute(0, 3, 1, 2, 4)  # [B,T,H,W,C]
    per_sample = (B, 1, 1, 1, 1)
    if brightness > 0:
        out = out + draws.delta.to(clip.device, out.dtype).reshape(per_sample)
    if contrast > 0:
        gain = draws.gain.to(clip.device, out.dtype).reshape(per_sample)
        mean = out.mean(dim=(1, 2, 3), keepdim=True)
        out = (out - mean) * gain + mean
    if hflip:
        out = torch.where(draws.flip.to(clip.device).reshape(per_sample), out.flip(3), out)
    return out.contiguous()


def augment_from_cfg(train_cfg: dict):
    """``augment_clip`` with the config's settings, or None when off.

    ``training.augment: true`` takes the defaults; a mapping
    ``{max_shift: 8, brightness: 0.2, contrast: 0.2, hflip: false}`` sets
    them."""
    aug = train_cfg.get("augment", False)
    if not aug:
        return None
    kwargs = dict(aug) if isinstance(aug, dict) else {}
    return functools.partial(augment_clip, **kwargs)
