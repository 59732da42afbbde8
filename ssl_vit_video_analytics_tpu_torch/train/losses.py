"""MAE reconstruction loss (the pipeline-B part of the JAX package's
``train/losses.py``): weighted-masked over full ``[B, N, D]`` tensors, sum
over masked tokens / masked count, in fp32."""
from __future__ import annotations

import torch

from ..ops.patchify import normalize_pix_target


def _masked_mean(per_token: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """per_token ``[B, N]``; mask ``[B, N]`` -> scalar mean over masked entries."""
    m = mask.to(per_token.dtype)
    return (per_token * m).sum() / torch.clamp(m.sum(), min=1.0)


def mae_loss_l2(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                normalize_target: bool = True, eps: float = 1e-6) -> torch.Tensor:
    """L2 with optional per-token target normalization (MAE default,
    ref: src/mae/losses.py:19-41). The variance is the biased one
    (``jnp.var``) and ``eps`` sits inside the square root."""
    pred = pred.float()
    target = target.detach().float()
    if normalize_target:
        target = normalize_pix_target(target, eps)
    per_token = ((pred - target) ** 2).mean(dim=-1)
    return _masked_mean(per_token, mask)
