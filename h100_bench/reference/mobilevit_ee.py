"""Plain fp32 reference of the early-exit action classifier: MobileViT-S
(arXiv 2110.02178) per frame, the mean of the frame embeddings so far, a
linear head, and confidence-based early exit.

MobileViT-S at 112x112: 3x3 stride-2 stem (16), inverted residuals (x4
expansion, SiLU; residual where the shape holds) 32, 32, 64, 64, 64; three
MobileViT blocks at 96/128/160 channels with transformer widths 128/160/192
(two pre-norm blocks each, 4 heads, MLP x2) behind stride-2 inverted
residuals; a 1x1 conv to the embedding width and the spatial mean. A
MobileViT block: 3x3 conv, 1x1 conv to the transformer width, the map
zero-padded on the bottom and right to even sides and flattened row-major
to tokens (attention over every position, pad tokens included), cropped
back, 1x1 conv to the input width, concatenated with the input, 3x3 conv.
Every conv is conv-BN-SiLU except the inverted residuals' projections (no
activation). BatchNorm uses its running statistics (inference).

Early exit over the first ``max_frames`` frames, visited 0, 1, 1+s, ...:
after each visit the clip's running-mean embedding is classified; a clip
exits at the first visit with at least ``min_frames`` frames whose top
softmax probability reaches the threshold, else after the last. It
returns that visit's logits and frame count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import FP32, Block, ConvBN, Precision, dense, normalize


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        hidden = cin * 4
        self.residual = stride == 1 and cin == cout
        self.expand = ConvBN(cin, hidden, 1, act=True)
        self.dw = ConvBN(hidden, hidden, 3, stride, groups=hidden, act=True)
        self.project = ConvBN(hidden, cout, 1)

    def forward(self, x, p):
        y = self.project(self.dw(self.expand(x, p), p), p)
        return x + y if self.residual else y


class MobileViTBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dim: int):
        super().__init__()
        self.dim = dim
        self.local_conv = ConvBN(cin, cin, 3, act=True)
        self.local_proj = ConvBN(cin, dim, 1, act=True)
        self.tblocks = nn.ModuleList(Block(dim, 4, 2.0) for _ in range(2))
        self.fuse_proj = ConvBN(dim, cin, 1, act=True)
        self.fuse_conv = ConvBN(2 * cin, cout, 3, act=True)

    def forward(self, x, p):
        N, C, H, W = x.shape
        y = self.local_proj(self.local_conv(x, p), p)
        ph, pw = H % 2, W % 2
        y = F.pad(y, (0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        t = y.permute(0, 2, 3, 1).reshape(N, Hp * Wp, self.dim)
        for blk in self.tblocks:
            t = blk(t, p)
        y = t.reshape(N, Hp, Wp, self.dim).permute(0, 3, 1, 2)[:, :, :H, :W]
        return self.fuse_conv(torch.cat([x, self.fuse_proj(y, p)], dim=1), p)


class Backbone(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.stem = ConvBN(3, 16, 3, 2, act=True)
        self.s1_0 = InvertedResidual(16, 32, 2)
        self.s1_1 = InvertedResidual(32, 32, 1)
        self.s2_0 = InvertedResidual(32, 64, 2)
        self.s2_1 = InvertedResidual(64, 64, 1)
        self.mvit1_ir = InvertedResidual(64, 64, 1)
        self.mvit1 = MobileViTBlock(64, 96, 128)
        self.mvit2_ir = InvertedResidual(96, 96, 2)
        self.mvit2 = MobileViTBlock(96, 128, 160)
        self.mvit3_ir = InvertedResidual(128, 128, 2)
        self.mvit3 = MobileViTBlock(128, 160, 192)
        self.head = ConvBN(160, embed_dim, 1, act=True)

    def forward(self, frames, p):
        x = frames.permute(0, 3, 1, 2)
        for m in (self.stem, self.s1_0, self.s1_1, self.s2_0, self.s2_1, self.mvit1_ir,
                  self.mvit1, self.mvit2_ir, self.mvit2, self.mvit3_ir, self.mvit3, self.head):
            x = m(x, p)
        return x.mean((2, 3))


class Classifier(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.backbone = Backbone(int(cfg["model"]["embed_dim"]))
        self.head = nn.Linear(int(cfg["model"]["embed_dim"]), int(cfg["dataset"]["num_classes"]))

    def embed(self, frames_u8, p: Precision = FP32) -> torch.Tensor:
        """uint8 ``[N, H, W, 3]`` frames -> ``[N, D]``."""
        return self.backbone(normalize(frames_u8), p)

    def classify(self, emb, p: Precision = FP32) -> torch.Tensor:
        return dense(emb, self.head, p)


@torch.no_grad()
def early_exit(model: Classifier, clips_u8, threshold: float, min_frames: int,
               max_frames: int, frame_step: int = 1, p: Precision = FP32):
    """``clips_u8`` ``[B, T, H, W, 3]`` -> ``(logits [B, K], used [B])``."""
    model.eval()
    B, T = clips_u8.shape[:2]
    T = min(T, max_frames)
    visits = [0] + list(range(1, T, max(frame_step, 1)))
    emb = model.embed(clips_u8[:, visits].reshape((-1,) + clips_u8.shape[2:]), p)
    emb = emb.reshape(B, len(visits), -1)
    counts = torch.arange(1, len(visits) + 1, device=emb.device)
    means = emb.cumsum(1) / counts[None, :, None]
    logits = model.classify(means, p)                           # [B, M, K]
    conf = torch.softmax(logits, -1).amax(-1)
    ok = (conf >= threshold) & (counts[None] >= max(min_frames, 1))
    last = torch.full((B,), len(visits) - 1, dtype=torch.long, device=emb.device)
    first = torch.where(ok.any(1), ok.int().argmax(1), last)
    rows = torch.arange(B, device=emb.device)
    return logits[rows, first], counts[first]
