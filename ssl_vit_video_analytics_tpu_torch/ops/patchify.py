"""Patchify / unpatchify and norm-pix targets for pixel-space MAE
(counterpart of the JAX package's ``ops/patchify.py``).

Clips are channel-last ``[B, T, H, W, C]``. Token order is the reference's:
per frame, patches in row-major ``(gh, gw)`` order, and within a patch the
pixels in ``(ph, pw, C)`` order.
"""
from __future__ import annotations

import torch


def patchify(clip: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, T, H, W, C]`` -> ``[B, T*L, patch_size**2 * C]``, L = (H/p)*(W/p)."""
    B, T, H, W, C = clip.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = clip.reshape(B, T, gh, p, gw, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T * gh * gw, p * p * C)


def unpatchify(tokens: torch.Tensor, patch_size: int, T: int, H: int, W: int,
               C: int = 3) -> torch.Tensor:
    """Inverse of :func:`patchify`: ``[B, T*L, p*p*C]`` -> ``[B, T, H, W, C]``."""
    B = tokens.shape[0]
    p = patch_size
    gh, gw = H // p, W // p
    x = tokens.reshape(B, T, gh, gw, p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, H, W, C)


def normalize_pix_target(target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-patch ``(x - mean) / sqrt(var + eps)`` with the biased variance
    (``jnp.var``), the MAE norm_pix_loss trick."""
    mean = target.mean(dim=-1, keepdim=True)
    var = target.var(dim=-1, keepdim=True, unbiased=False)
    return (target - mean) / torch.sqrt(var + eps)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over masked tokens only; ``mask`` ``[B, N]``,
    True = masked (in the loss)."""
    m = mask.to(pred.dtype)
    per_token = ((pred - target) ** 2).mean(dim=-1)
    return (per_token * m).sum() / torch.clamp(m.sum(), min=1.0)
