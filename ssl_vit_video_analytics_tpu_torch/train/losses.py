"""Loss library (counterpart of the JAX package's ``train/losses.py``): the
MAE reconstruction losses of pipelines B and C, and pipeline A's losses.

MAE losses are weighted-masked over full ``[B, N, D]`` tensors, sum over
masked tokens / masked count, in fp32 (ref: src/mae/losses.py:19-90).
With a ``group`` (a ``data`` or ``seq`` mesh's) the count is the global
one: each rank's loss is its share of the global loss
(``parallel/collectives.py``), and the statistics are global.
Pipeline-A losses (ref: src/train_ssl.py:26-34): the negative-cosine
BYOL-style loss (2 - 2*cos) and the VICReg variance hinge.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.patchify import normalize_pix_target
from ..parallel.collectives import all_reduce


def _masked_mean(per_token: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """per_token ``[B, N]``; mask ``[B, N]`` -> scalar mean over masked
    entries (with ``group``: this rank's sum over the group's count)."""
    m = mask.to(per_token.dtype)
    count = m.sum() if group is None else all_reduce(m.sum(), group)
    return (per_token * m).sum() / torch.clamp(count, min=1.0)


@torch.no_grad()
def global_std(x: torch.Tensor, group=None) -> torch.Tensor:
    """The biased std of every entry of ``x`` (fp32), over the group's
    entries with ``group`` (two passes: the global mean, then the squares
    about it)."""
    x = x.float()
    if group is None:
        return x.std(unbiased=False)
    s = all_reduce(torch.stack([x.sum(), x.new_tensor(float(x.numel()))]), group)
    mean = s[0] / s[1]
    return torch.sqrt(all_reduce((x - mean).square().sum(), group) / s[1])


def l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x over its L2 norm along the last axis, the norm held at ``eps`` or more."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def mae_loss_l2(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                normalize_target: bool = True, eps: float = 1e-6, group=None) -> torch.Tensor:
    """L2 with optional per-token target normalization (MAE default,
    ref: src/mae/losses.py:19-41). The variance is the biased one
    (``jnp.var``) and ``eps`` sits inside the square root."""
    pred = pred.float()
    target = target.detach().float()
    if normalize_target:
        target = normalize_pix_target(target, eps)
    per_token = ((pred - target) ** 2).mean(dim=-1)
    return _masked_mean(per_token, mask, group)


def mae_loss_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                group=None) -> torch.Tensor:
    """L1 over masked tokens (ref: src/mae/losses.py:44-49)."""
    per_token = (pred.float() - target.detach().float()).abs().mean(dim=-1)
    return _masked_mean(per_token, mask, group)


def mae_loss_cosine(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                    eps: float = 1e-8, group=None) -> torch.Tensor:
    """1 - cosine over masked tokens (ref: src/mae/losses.py:52-63)."""
    p = l2_normalize(pred.float(), eps)
    t = l2_normalize(target.detach().float(), eps)
    return _masked_mean(1.0 - (p * t).sum(dim=-1), mask, group)


def build_mae_loss(loss_type: str, normalize_target: bool = True, group=None):
    """Dispatch (ref: src/mae/losses.py:69-90)."""
    if loss_type == "l2":
        return lambda p, t, m: mae_loss_l2(p, t, m, normalize_target=normalize_target,
                                           group=group)
    if loss_type == "l1":
        return lambda p, t, m: mae_loss_l1(p, t, m, group=group)
    if loss_type == "cosine":
        return lambda p, t, m: mae_loss_cosine(p, t, m, group=group)
    raise ValueError(f"Unknown mae loss type: {loss_type}")


@torch.no_grad()
def reconstruction_error_stats(pred: torch.Tensor, target: torch.Tensor,
                               mask: torch.Tensor, group=None) -> dict:
    """Diagnostics with the reference's key names ``mae_l1``/``mae_l2``/
    ``pred_std``/``target_std`` over masked tokens (ref:
    src/mae/losses.py:96-108), fp32 device scalars; over the group's tokens
    with ``group``."""
    p, t = pred.float(), target.float()
    m = mask.float()

    def total(x):
        return x if group is None else all_reduce(x, group)

    denom = torch.clamp(total(m.sum()), min=1.0)
    l1 = total(((p - t).abs().mean(dim=-1) * m).sum()) / denom
    l2 = total((((p - t) ** 2).mean(dim=-1) * m).sum()) / denom

    def masked_std(x):
        n = denom * x.shape[-1]
        mean = total((x * m[..., None]).sum()) / n
        return torch.sqrt(total((((x - mean) ** 2) * m[..., None]).sum()) / n)

    return {"mae_l1": l1, "mae_l2": l2, "pred_std": masked_std(p), "target_std": masked_std(t)}


# ---------------- pipeline A (teacher-student SSL) ----------------

def cosine_loss(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """2 - 2*cos(p, z), mean over rows (ref: src/train_ssl.py:26-29)."""
    return 2.0 - 2.0 * (l2_normalize(p, 1e-12) * l2_normalize(z, 1e-12)).sum(dim=-1).mean()


def variance_loss(z: torch.Tensor, target_std: float = 1.0, eps: float = 1e-4) -> torch.Tensor:
    """VICReg variance hinge: mean relu(target_std - std(z, axis=0)), with the
    biased variance (ref: src/train_ssl.py:31-34)."""
    std = torch.sqrt(z.float().var(dim=0, unbiased=False) + eps)
    return F.relu(target_std - std).mean()
