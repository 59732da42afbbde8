"""Plain fp32 reference of pipeline B with a mixture-of-experts decoder:
``tinyvit_mae``'s VideoMAE over TinyViT (its encoder, loss, schedule and
AdamW by import), with every decoder MLP split into top-1-routed experts
(Switch Transformer, arXiv 2101.03961) under a static capacity per group of
tokens (GShard, arXiv 2006.16668).

The MoE MLP, written from the papers:

- router: a dense layer to E logits, softmax (fp32 in the reference);
- each token takes its argmax expert, and that expert's output is scaled
  by the token's probability for it (the gate);
- tokens route within consecutive groups of ``group_size``; in each group
  an expert has ``C = max(1, ceil(group_size * capacity_factor / E))``
  slots, taken by its tokens in token order; a token past the C-th is
  dropped: its MLP output is 0, so the block's residual carries it;
- each expert's MLP (``x W1 + b1``, GELU, ``W2 + b2``, ``W1 [D, H]``) runs
  by index on the tokens it keeps, and its gated outputs are added back at
  those tokens' rows;
- the Switch auxiliary ``E * sum_e f_e * P_e`` (``f_e`` the share of the
  layer's tokens whose argmax is e, ``P_e`` the mean of their probabilities
  for e) of each MoE block, averaged over the blocks, joins the loss at
  ``ssl.moe_aux_weight``.

Its parameter names are the program's (``router``, ``w1 [E, D, H]``, ``b1``,
``w2 [E, H, D]``, ``b2``), so one state dict loads into both. Every matrix
product takes its operands through a :class:`~.common.Precision`, the
router's too.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import tinyvit_mae as dense_ref
from .common import (FP32, NORM_EPS, Attention, Precision, dense, gelu, layer_norm, normalize,
                     remat)


class MoeMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, experts: int, capacity_factor: float,
                 group_size: int):
        super().__init__()
        self.experts, self.capacity_factor, self.group_size = experts, capacity_factor, group_size
        self.router = nn.Linear(dim, experts)
        self.w1 = nn.Parameter(torch.zeros(experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(experts, hidden))
        self.w2 = nn.Parameter(torch.zeros(experts, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(experts, dim))

    def capacity(self, tokens: int) -> tuple[int, int]:
        """Tokens a group and slots an expert has in a group."""
        S = self.group_size or tokens
        return S, max(1, math.ceil(S * self.capacity_factor / self.experts))

    def forward(self, x: torch.Tensor, p: Precision):
        """``x [B, L, D]`` -> ``(y [B, L, D], aux, route [B*L])``: ``route``
        is each token's expert, or -1 where the token was dropped."""
        B, L, D = x.shape
        N, E = B * L, self.experts
        xs = x.reshape(N, D)
        probs = torch.softmax(dense(xs, self.router, p), -1)
        expert = probs.argmax(-1)
        gate = probs.gather(1, expert[:, None])
        S, C = self.capacity(N)
        # a token's slot: how many earlier tokens of its group chose its expert
        key = torch.arange(N, device=x.device) // S * E + expert
        order = torch.sort(key, stable=True).indices
        first = torch.searchsorted(key[order], key[order])
        slot = torch.empty_like(key)
        slot[order] = torch.arange(N, device=x.device) - first
        kept = slot < C
        y = torch.zeros_like(xs)
        for e in range(E):
            rows = torch.nonzero(kept & (expert == e)).flatten()
            if rows.numel() == 0:
                continue
            h = gelu(p(xs[rows]) @ p(self.w1[e]) + self.b1[e])
            y = y.index_add(0, rows, gate[rows] * (p(h) @ p(self.w2[e]) + self.b2[e]))
        share = torch.bincount(expert, minlength=E).float() / N
        aux = E * (share * probs.mean(0)).sum()
        return y.reshape(B, L, D), aux, torch.where(kept, expert, -1)


class MoeBlock(nn.Module):
    """``common.Block`` with a :class:`MoeMlp` in its MLP's place; the
    decoder's blocks have no stochastic depth."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, experts: int,
                 capacity_factor: float, group_size: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.mlp = MoeMlp(dim, int(dim * mlp_ratio), experts, capacity_factor, group_size)

    def forward(self, x: torch.Tensor, p: Precision):
        x = x + self.attn(layer_norm(x, self.norm1), p)
        h, aux, route = self.mlp(layer_norm(x, self.norm2), p)
        return x + h, aux, route


class TinyVideoMAE(dense_ref.TinyVideoMAE):
    """``tinyvit_mae.TinyVideoMAE`` with MoE decoder blocks
    (``model.decoder_moe_*``)."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        m = cfg["model"]
        D = int(m["decoder_embed_dim"])
        self.decoder.blocks = nn.ModuleList(
            MoeBlock(D, int(m["decoder_num_heads"]), 4.0, int(m["decoder_moe_experts"]),
                     float(m["decoder_moe_capacity_factor"]),
                     int(m.get("decoder_moe_group_size", 0) or 0))
            for _ in range(int(m["decoder_depth"])))

    def forward(self, clip_u8, mask, keeps, p: Precision = FP32, recompute: bool = True):
        """As ``tinyvit_mae.TinyVideoMAE.forward``; returns ``(pred,
        normalized clip, auxes, routes)``, one aux and one route a block."""
        x = normalize(clip_u8)
        B, T, H, W, _ = x.shape
        remat_on = recompute and torch.is_grad_enabled()
        lat = self.encoder(x.reshape(B * T, H, W, 3), p, keeps, remat_on)
        L, D = lat.shape[1], self.mask_token.shape[-1]
        t = dense(lat, self.enc_to_dec, p).reshape(B, T, L, D)
        t = t + self.temporal_pos_embed[:, :T] + self.spatial_pos_embed
        m = mask.reshape(B, T, L, 1).float()
        t = (t * (1.0 - m) + self.mask_token[:, None] * m).reshape(B, T * L, D)
        auxes, routes = [], []
        for blk in self.decoder.blocks:
            t, aux, route = remat(blk, t, p, on=remat_on)
            auxes.append(aux)
            routes.append(route)
        return dense(layer_norm(t, self.decoder_norm), self.decoder_pred, p), x, auxes, routes


class Trainer(dense_ref.Trainer):
    """``tinyvit_mae.Trainer`` over the MoE model: the loss adds
    ``ssl.moe_aux_weight`` times the blocks' mean auxiliary; ``routes`` is
    each block's route (:meth:`MoeMlp.forward`) at the first micro-step."""

    def __init__(self, model: TinyVideoMAE, cfg: dict, steps_per_epoch: int,
                 p: Precision = FP32):
        super().__init__(model, cfg, steps_per_epoch, p)
        self.aux_weight = float(cfg.get("ssl", {}).get("moe_aux_weight", 0.01))
        self.routes: list[torch.Tensor] | None = None

    def step(self, clip_u8, mask, keeps) -> float:
        """One micro-step; returns its loss."""
        self.model.train()
        pred, x, auxes, routes = self.model(clip_u8, mask, keeps, self.p)
        if self.routes is None:
            self.routes = [r.detach() for r in routes]
        loss = (dense_ref.masked_norm_pix_mse(pred, x, mask, self.model.patch)
                + self.aux_weight * torch.stack(auxes).mean())
        grads = torch.autograd.grad(loss, self.params)
        with torch.no_grad():
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.micro + 1))
            self.micro += 1
            if self.micro == self.accum:
                if self.first_grad is None:
                    self.first_grad = [a.clone() for a in self.acc]
                if all(bool(torch.isfinite(a).all()) for a in self.acc):
                    self._adamw(self.acc)
                self.micro = 0
                for a in self.acc:
                    a.zero_()
        return float(loss.detach())
