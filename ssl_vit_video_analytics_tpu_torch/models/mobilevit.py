"""MobileViT-S backbone (counterpart of the JAX package's
``models/mobilevit.py``), same topology, widths and parameter count.

As in the JAX package, a MobileViT block flattens its (padded) H*W grid to
tokens directly: its attention has no positional encoding and spans all
positions, so the reference's unfold/fold permutation cancels. Odd grids
(7x7 at 112x112 input) are zero-padded to a multiple of ``patch_size`` before
attention and cropped after; the pad tokens are real attention keys.

Public layout is NHWC; the backbone works in NCHW inside.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBNAct, InvertedResidual, TransformerBlock


class MobileViTBlock(nn.Module):
    """Local convs + global transformer + fuse, on NCHW maps."""

    def __init__(self, in_ch: int, out_features: int, dim: int, patch_size: int = 2,
                 depth: int = 2, num_heads: int = 4, mlp_ratio: float = 2.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.patch_size = patch_size
        self.local_conv = ConvBNAct(in_ch, in_ch, kernel=3, dtype=dtype)
        self.local_proj = ConvBNAct(in_ch, dim, kernel=1, dtype=dtype)
        self.tblocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio=mlp_ratio, dtype=dtype)
            for _ in range(depth))
        self.fuse_proj = ConvBNAct(dim, in_ch, kernel=1, dtype=dtype)
        self.fuse_conv = ConvBNAct(2 * in_ch, out_features, kernel=3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        y = self.local_proj(self.local_conv(x))

        ps = self.patch_size
        pad_h, pad_w = (ps - H % ps) % ps, (ps - W % ps) % ps
        if pad_h or pad_w:
            y = F.pad(y, (0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w

        tokens = y.permute(0, 2, 3, 1).reshape(B, Hp * Wp, self.dim)
        for blk in self.tblocks:
            tokens = blk(tokens)
        y = tokens.reshape(B, Hp, Wp, self.dim).permute(0, 3, 1, 2)
        if pad_h or pad_w:
            y = y[:, :, :H, :W]

        y = self.fuse_proj(y)
        return self.fuse_conv(torch.cat([x, y], dim=1))


class MobileViTBackbone(nn.Module):
    """``[N, H, W, 3]`` -> ``(feat_map [N, h, w, D], emb [N, D])``."""

    def __init__(self, embed_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.embed_dim = embed_dim
        self.stem = ConvBNAct(3, 16, kernel=3, stride=2, dtype=d)
        self.s1_0 = InvertedResidual(16, 32, stride=2, dtype=d)
        self.s1_1 = InvertedResidual(32, 32, stride=1, dtype=d)
        self.s2_0 = InvertedResidual(32, 64, stride=2, dtype=d)
        self.s2_1 = InvertedResidual(64, 64, stride=1, dtype=d)
        self.mvit1_ir = InvertedResidual(64, 64, stride=1, dtype=d)
        self.mvit1 = MobileViTBlock(64, 96, dim=128, dtype=d)
        self.mvit2_ir = InvertedResidual(96, 96, stride=2, dtype=d)
        self.mvit2 = MobileViTBlock(96, 128, dim=160, dtype=d)
        self.mvit3_ir = InvertedResidual(128, 128, stride=2, dtype=d)
        self.mvit3 = MobileViTBlock(128, 160, dim=192, dtype=d)
        self.head = ConvBNAct(160, embed_dim, kernel=1, dtype=d)

    def draw_drop_path(self, n: int, generator: torch.Generator, device=None) -> None:
        """No stochastic depth: no decisions."""
        return None

    def forward(self, x: torch.Tensor, drop: None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``drop``: always None (no drop path)."""
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        for stage in (self.stem, self.s1_0, self.s1_1, self.s2_0, self.s2_1,
                      self.mvit1_ir, self.mvit1, self.mvit2_ir, self.mvit2,
                      self.mvit3_ir, self.mvit3, self.head):
            x = stage(x)
        emb = x.mean(dim=(2, 3))
        return x.permute(0, 2, 3, 1), emb

