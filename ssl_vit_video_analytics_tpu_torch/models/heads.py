"""Classification and multi-task SSL heads (counterpart of the JAX package's
``models/heads.py``; ref: src/models/heads.py).

``SSLMultiTaskHead`` mirrors the reference's historical SSL variant (masked
feature reconstruction MLP + pairwise 2-way temporal-order head,
ref: src/models/heads.py:24-113). It is orphaned in the reference but kept in
the inventory for parity. Flax builds these denses lazily at their input
width; here the input width is an argument.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import gelu, linear


class ClassificationHead(nn.Module):
    """GAP (if given a NHWC feature map) + Linear (ref: src/models/heads.py:6-21)."""

    def __init__(self, in_dim: int, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = nn.Linear(in_dim, num_classes)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:  # [B, H, W, C] feature map
            x = x.mean(dim=(1, 2))
        return linear(x, self.fc, self.dtype)


class SSLMultiTaskHead(nn.Module):
    """Masked-feature-reconstruction MLP + 2-way temporal-order head.

    ``forward(tokens, targets, mask, order_pairs, order_labels)`` -> loss
    dict. tokens/targets ``[B, T, D]``; mask ``[B, T]`` bool; order_pairs
    ``[B, 2]`` frame index pairs; order_labels ``[B]`` in {0, 1} (is the
    pair in order).
    """

    def __init__(self, embed_dim: int, mfm_weight: float = 1.0, order_weight: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D = embed_dim
        self.fc1 = nn.Linear(D, 2 * D)
        self.fc2 = nn.Linear(2 * D, D)
        self.order = nn.Linear(2 * D, 2)
        self.mfm_weight, self.order_weight = mfm_weight, order_weight
        self.dtype = dtype

    def forward(self, tokens, targets, mask, order_pairs, order_labels) -> dict:
        D = tokens.shape[-1]
        recon = linear(gelu(linear(tokens, self.fc1, self.dtype)), self.fc2, self.dtype)
        m = mask.to(recon.dtype)[..., None]
        mfm = (((recon - targets.detach()) ** 2) * m).sum() / (
            torch.clamp(m.sum(), min=1.0) * D)
        b = torch.arange(tokens.shape[0], device=tokens.device)
        pair = torch.cat([tokens[b, order_pairs[:, 0]], tokens[b, order_pairs[:, 1]]], dim=-1)
        logits = linear(pair, self.order, self.dtype)
        order = F.cross_entropy(logits.float(), order_labels.long())
        return {"loss": self.mfm_weight * mfm + self.order_weight * order,
                "mfm": mfm, "order": order}
