"""TemporalSSL: MobileViT encoder + temporal transformer for SSL pipeline A
(counterpart of the JAX package's ``models/temporal.py``; ref:
src/train_ssl.py:97-158).

Per-frame MobileViT embeddings (the ``B*T`` frames as one batch), a learned
temporal position embedding, mask-token substitution on masked FRAMES, a
pre-norm temporal transformer producing context tokens, a BatchNorm-MLP
predictor, and a 4-way temporal-order (TOP) head. Every attention layer,
MobileViT's and the temporal transformer's, goes through
``ops/attention.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import TransformerEncoder, batch_norm, gelu, linear
from .mobilevit import MobileViTBackbone


class TemporalSSL(nn.Module):
    def __init__(self, embed_dim: int = 256, layers: int = 4, heads: int = 4,
                 clip_len: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.encoder = MobileViTBackbone(embed_dim=embed_dim, dtype=dtype)
        self.pos = nn.Parameter(torch.zeros(1, clip_len, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        for p in (self.pos, self.mask_token):
            nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04)  # flax truncated_normal(0.02)
        self.temporal = TransformerEncoder(embed_dim, layers, heads, mlp_ratio=4.0, dtype=dtype)
        self.predictor_fc1 = nn.Linear(embed_dim, embed_dim)
        self.predictor_bn1 = nn.BatchNorm1d(embed_dim, eps=1e-5)
        self.predictor_fc2 = nn.Linear(embed_dim, embed_dim)
        self.top_head = nn.Linear(embed_dim, 4)

    def forward(self, clip: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """``forward_tokens``: clip ``[B, T, H, W, 3]``; mask ``[B, T]`` bool
        or None -> context ``[B, T, D]`` in the compute dtype. Training or
        eval follows the module's mode (BatchNorm statistics)."""
        B, T, H, W, C = clip.shape
        _, f = self.encoder(clip.reshape(B * T, H, W, C))
        f = f.reshape(B, T, self.embed_dim)
        f = f + self.pos[:, :T].to(f.dtype)
        if mask is not None:
            f = torch.where(mask[..., None], self.mask_token.to(f.dtype), f)
        return self.temporal(f)

    forward_tokens = forward

    def predictor(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, D] -> [N, D]`` MLP with BatchNorm (ref: src/train_ssl.py:128-136);
        in training the BatchNorm moves its running statistics."""
        x = linear(x, self.predictor_fc1, self.dtype)
        x = batch_norm(x, self.predictor_bn1, self.training).to(self.dtype)
        return linear(gelu(x), self.predictor_fc2, self.dtype)

    def top_logits(self, ctx: torch.Tensor) -> torch.Tensor:
        """Temporal-order logits from mean-pooled context ``[B, T, D]``
        (ref: src/train_ssl.py:238-246)."""
        return linear(ctx.mean(dim=1), self.top_head, self.dtype)
