"""Plain fp32 reference of pipeline B: VideoMAE pixel reconstruction over a
TinyViT encoder cut after stage 3 (TinyViT, arXiv 2207.10666; VideoMAE,
arXiv 2203.12602), with its training step: tube mask, norm-pix masked MSE,
AdamW (decoupled weight decay on every parameter) under a warmup-cosine
schedule, gradient accumulation by the running mean of micro-batches, and
the skip of a non-finite update.

Stem: 3x3 stride-2 conv to dim0/2, GELU, 3x3 conv to dim0 (both BN, no act).
Stage 0: MBConv blocks (1x1 expand x4, GELU, 3x3 depthwise, GELU, squeeze-
excite (mean, 1x1 /4, ReLU, 1x1, sigmoid), 1x1 project; residual with
stochastic depth). Stages 1-2: a stride-2 MBConv, then pre-norm transformer
blocks over the h*w tokens (heads of width dim/heads, MLP x4). Each frame
is encoded alone; its 14x14 stage-2 map is projected to the decoder width,
gets factorized temporal + spatial position embeddings, masked tokens are
replaced by the mask token, and a full-sequence transformer decoder over
all T*196 tokens predicts each 8x8x3 patch.

Under gradients each block is recomputed in the backward pass
(``torch.utils.checkpoint``): the same arithmetic, less memory.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .common import (FP32, Block, ConvBN, Precision, dense, drop_path, gelu, layer_norm,
                     normalize, remat)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.fc1 = nn.Linear(ch, ch // 4, bias=False)
        self.fc2 = nn.Linear(ch // 4, ch, bias=False)

    def forward(self, x, p):
        s = torch.sigmoid(dense(torch.relu(dense(x.mean((2, 3)), self.fc1, p)), self.fc2, p))
        return x * s[:, :, None, None]


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        mid = cin * 4
        self.residual = stride == 1 and cin == cout
        self.expand = ConvBN(cin, mid, 1)
        self.dw = ConvBN(mid, mid, 3, stride, groups=mid)
        self.se = SqueezeExcite(mid)
        self.project = ConvBN(mid, cout, 1)

    def forward(self, x, p, keep=None):
        y = self.project(self.se(gelu(self.dw(gelu(self.expand(x, p)), p)), p), p)
        return x + drop_path(y, keep) if self.residual else y


class Stem(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = ConvBN(3, dim // 2, 3, 2)
        self.conv2 = ConvBN(dim // 2, dim, 3, 1)

    def forward(self, x, p):
        return self.conv2(gelu(self.conv1(x, p)), p)


class Stage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, heads: int, index: int):
        super().__init__()
        self.index = index
        if index == 0:
            self.down = None
            self.mbconvs = nn.ModuleList(MBConv(dim, dim) for _ in range(depth))
        else:
            self.down = MBConv(cin, dim, stride=2)
            self.tblocks = nn.ModuleList(Block(dim, heads, 4.0) for _ in range(depth))

    def forward(self, x, p, keeps, ckpt: bool = False):
        if self.down is None:
            for blk, keep in zip(self.mbconvs, keeps):
                x = remat(blk, x, p, keep, on=ckpt)
            return x
        x = remat(self.down, x, p, on=ckpt)
        N, C, H, W = x.shape
        t = x.flatten(2).transpose(1, 2)
        for blk, keep in zip(self.tblocks, keeps):
            t = remat(blk, t, p, keep, on=ckpt)
        return t.transpose(1, 2).reshape(N, C, H, W)


class Encoder(nn.Module):
    """TinyViT's first three stages."""

    def __init__(self, dims, depths, heads):
        super().__init__()
        self.patch_embed = Stem(dims[0])
        self.stages = nn.ModuleList(
            Stage(dims[max(i - 1, 0)], dims[i], depths[i], heads[i], i) for i in range(3))

    def forward(self, frames, p, keeps, recompute: bool):
        """``frames`` ``[N, H, W, 3]`` normalized -> ``[N, h*w, dims[2]]``."""
        x = self.patch_embed(frames.permute(0, 3, 1, 2), p)
        for stage, k in zip(self.stages, keeps):
            x = stage(x, p, k, recompute)
        return x.flatten(2).transpose(1, 2)


class TinyVideoMAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        m, d = cfg["model"], cfg["dataset"]
        dims = tuple(m["embed_dims"])
        self.depths, self.heads = (2, 2, 6), (3, 6, 12)
        self.drop_path_rate = 0.1       # TinyViT's default, ramped over its 12 blocks
        self.patch = 8
        self.clip_len, self.image_size = int(d["clip_len"]), int(d["image_size"])
        D = int(m["decoder_embed_dim"])
        L = (self.image_size // self.patch) ** 2
        self.encoder = Encoder(dims, self.depths, self.heads)
        self.enc_to_dec = nn.Linear(dims[2], D)
        self.temporal_pos_embed = nn.Parameter(torch.zeros(1, self.clip_len, 1, D))
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, 1, L, D))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, D))
        self.decoder = nn.Module()
        self.decoder.blocks = nn.ModuleList(
            Block(D, int(m["decoder_num_heads"]), 4.0) for _ in range(int(m["decoder_depth"])))
        self.decoder_norm = nn.LayerNorm(D, eps=1e-5)
        self.decoder_pred = nn.Linear(D, self.patch ** 2 * 3)

    def drop_rates(self) -> list[list[float]]:
        """Each encoder block's stochastic-depth rate: a linear ramp from 0
        to 0.1 over all 12 blocks of TinyViT's four stages (the last stage,
        not built here, keeps its two). Stage 0's first block is the only
        one at 0; the stride-2 blocks have none."""
        ramp = np.linspace(0.0, self.drop_path_rate, 12).tolist()
        out, cur = [], 0
        for n in self.depths:
            out.append(ramp[cur:cur + n])
            cur += n
        return out

    def forward(self, clip_u8, mask, keeps, p: Precision = FP32, recompute: bool = True):
        """``clip_u8`` ``[B, T, H, W, 3]``; ``mask`` ``[B, T, L]`` (True =
        masked); ``keeps``: per stage, per block, the per-frame keep
        factors (a tensor for an MBConv, a pair for a transformer block, or
        None). Returns ``(pred [B, T*L, 192], normalized clip)``."""
        x = normalize(clip_u8)
        B, T, H, W, _ = x.shape
        remat_on = recompute and torch.is_grad_enabled()
        lat = self.encoder(x.reshape(B * T, H, W, 3), p, keeps, remat_on)
        L, D = lat.shape[1], self.mask_token.shape[-1]
        t = dense(lat, self.enc_to_dec, p).reshape(B, T, L, D)
        t = t + self.temporal_pos_embed[:, :T] + self.spatial_pos_embed
        m = mask.reshape(B, T, L, 1).float()
        t = (t * (1.0 - m) + self.mask_token[:, None] * m).reshape(B, T * L, D)
        for blk in self.decoder.blocks:
            t = remat(blk, t, p, on=remat_on)
        return dense(layer_norm(t, self.decoder_norm), self.decoder_pred, p), x


def patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, T, H, W, C]`` -> ``[B, T*(H/p)*(W/p), p*p*C]``: per frame, the
    patches in row-major order, each patch's pixels in (row, column,
    channel) order."""
    B, T, H, W, C = x.shape
    x = x.reshape(B, T, H // patch, patch, W // patch, patch, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, -1, patch * patch * C)


def masked_norm_pix_mse(pred, x, mask, patch: int) -> torch.Tensor:
    """Mean over masked patches of the per-patch MSE against the patch's
    pixels standardized by its own mean and (biased) variance + 1e-6."""
    target = patches(x, patch)
    mean = target.mean(-1, keepdim=True)
    var = (target - mean).square().mean(-1, keepdim=True)
    target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = (pred - target).square().mean(-1)
    m = mask.reshape(per_patch.shape).float()
    return (per_patch * m).sum() / m.sum().clamp_min(1.0)


def schedule(base_lr: float, warmup_steps: int, total_steps: int, min_lr: float):
    """Learning rate after ``count`` updates: linear from 0 over at least
    one warm-up update, then a cosine from ``base_lr`` to ``min_lr``."""
    if warmup_steps >= total_steps:
        warmup_steps = max(total_steps - 1, 0)
    warmup_steps = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup_steps

    def lr(count: int) -> float:
        if count < warmup_steps:
            return base_lr * count / warmup_steps
        t = min(count - warmup_steps, decay)
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * t / decay))

    return lr


class Trainer:
    """The reference training step over ``model``'s parameters: AdamW
    (b1 0.9, b2 0.999, eps 1e-8, decoupled decay), fed the running mean of
    ``accum`` micro-batch gradients, an update skipped where any is not
    finite."""

    def __init__(self, model: TinyVideoMAE, cfg: dict, steps_per_epoch: int,
                 p: Precision = FP32):
        tr = cfg["training"]
        self.model, self.p = model, p
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [q for _, q in model.named_parameters()]
        self.accum = int(tr.get("accumulation_steps", 1))
        self.wd = float(tr.get("weight_decay", 0.05))
        self.lr = schedule(float(tr["lr"]), int(tr.get("warmup_epochs", 0)) * steps_per_epoch,
                           int(tr["epochs"]) * steps_per_epoch, float(tr.get("min_lr", 0.0)))
        self.m = [torch.zeros_like(q) for q in self.params]
        self.v = [torch.zeros_like(q) for q in self.params]
        self.acc = [torch.zeros_like(q) for q in self.params]
        self.micro, self.count = 0, 0
        self.first_grad: list[torch.Tensor] | None = None

    def step(self, clip_u8, mask, keeps) -> float:
        """One micro-step; returns its loss."""
        self.model.train()
        pred, x = self.model(clip_u8, mask, keeps, self.p)
        loss = masked_norm_pix_mse(pred, x, mask, self.model.patch)
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

    def _adamw(self, grads) -> None:
        lr, b1, b2, eps = self.lr(self.count), 0.9, 0.999, 1e-8
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for q, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            q.sub_(lr * ((m / c1) / ((v / c2).sqrt() + eps) + self.wd * q))
