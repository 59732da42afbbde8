"""TinyViT-21M variant for 112x112 inputs (counterpart of the JAX package's
``models/tiny_vit.py``), same topology, widths and parameter tree.

Conv stem (stride 2 then 1 -> 56x56), stage 0 = MBConv x depth, stages 1-3 =
MBConv downsample + full-attention transformer blocks, dims
[96, 192, 384, 576], depths [2, 2, 6, 2], heads [3, 6, 12, 18], key_dim =
dim/heads, stochastic depth ramped linearly to ``drop_path_rate`` over ALL
blocks of all four stages, also when fewer stages are built.

Unlike flax, which creates a stage's parameters only when it runs, a torch
module holds what it builds: ``num_stages=3`` builds the MAE pretraining
tap (``forward_stage3``, ``[N, 14, 14, 384]`` at 112x112) and nothing more.

Activation checkpointing (the JAX package's ``nn.remat`` per stage) is
``torch.utils.checkpoint`` per stage in training. The recompute sees the
same stochastic-depth decisions (they are arguments, drawn before the
forward) and updates no BatchNorm statistics (:func:`frozen_bn_stats`).

Public layout is NHWC; the stages work in NCHW inside.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import ConvBNAct, MBConv, TransformerBlock, frozen_bn_stats, gelu


class PatchEmbed(nn.Module):
    """Stem tuned for 112x112: stride 2 then stride 1 (ref: src/models/tiny_vit.py:62-72)."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNAct(3, embed_dim // 2, kernel=3, stride=2, act=False, dtype=dtype)
        self.conv2 = ConvBNAct(embed_dim // 2, embed_dim, kernel=3, stride=1, act=False,
                               dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(gelu(self.conv1(x)))


class TinyViTStage(nn.Module):
    """One stage: optional MBConv downsample + depth blocks (conv or attention)."""

    def __init__(self, in_ch: int, dim: int, depth: int, num_heads: int, downsample: bool,
                 conv_only: bool, drop_paths: Sequence[float],
                 dtype: torch.dtype = torch.float32, attn_impl: str | None = None):
        super().__init__()
        self.down = MBConv(in_ch, dim, stride=2, dtype=dtype) if downsample else None
        self.conv_only = conv_only
        if conv_only:
            self.mbconvs = nn.ModuleList(MBConv(dim, dim, drop_path=drop_paths[j], dtype=dtype)
                                         for j in range(depth))
        else:
            self.tblocks = nn.ModuleList(
                TransformerBlock(dim, num_heads, mlp_ratio=4.0, drop_path=drop_paths[j],
                                 dtype=dtype, attn_impl=attn_impl)
                for j in range(depth))

    @property
    def blocks(self) -> nn.ModuleList:
        return self.mbconvs if self.conv_only else self.tblocks

    def draw_drop_path(self, n: int, generator: torch.Generator, device=None) -> list:
        return [blk.draw_drop_path(n, generator, device) for blk in self.blocks]

    def forward(self, x: torch.Tensor, drop: list | None = None) -> torch.Tensor:
        """``x`` NCHW; ``drop``: per block, its stochastic-depth decisions."""
        if self.down is not None:
            x = self.down(x)
        drop = drop or [None] * len(self.blocks)
        if self.conv_only:
            for blk, keep in zip(self.blocks, drop):
                x = blk(x, keep)
            return x
        B, C, H, W = x.shape
        t = x.flatten(2).transpose(1, 2)  # [B, H*W, C], row-major (h, w) tokens
        for blk, keep in zip(self.blocks, drop):
            t = blk(t, keep)
        return t.transpose(1, 2).reshape(B, C, H, W)


def _remat(stage: TinyViTStage, x: torch.Tensor, drop: list | None) -> torch.Tensor:
    """Run ``stage`` under activation checkpointing; its recompute in the
    backward pass leaves the BatchNorm running statistics alone."""
    calls = [0]

    def run(inp):
        calls[0] += 1
        with frozen_bn_stats(stage, calls[0] > 1):
            return stage(inp, drop)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class TinyViT(nn.Module):
    def __init__(self, embed_dims: Sequence[int] = (96, 192, 384, 576),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 18),
                 drop_path_rate: float = 0.1, use_checkpoint: bool = True,
                 remat_stages: Sequence[int] | None = None,
                 dtype: torch.dtype = torch.float32, attn_impl: str | None = None,
                 num_stages: int = 4):
        super().__init__()
        self.embed_dims = tuple(embed_dims)
        self.use_checkpoint = use_checkpoint
        self.remat_stages = None if remat_stages is None else tuple(remat_stages)
        self.patch_embed = PatchEmbed(embed_dims[0], dtype=dtype)
        # the ramp spans every block of every stage, built or not (:87)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        stages, cur = [], 0
        for i in range(num_stages):
            stages.append(TinyViTStage(
                embed_dims[max(i - 1, 0)], embed_dims[i], depths[i], num_heads[i],
                downsample=i > 0, conv_only=i == 0,
                drop_paths=dpr[cur:cur + depths[i]], dtype=dtype, attn_impl=attn_impl))
            cur += depths[i]
        self.stages = nn.ModuleList(stages)

    def draw_drop_path(self, n: int, generator: torch.Generator, device=None,
                       stage_limit: int | None = None) -> list:
        """Stochastic-depth decisions for ``n`` frames, per stage and block."""
        return [s.draw_drop_path(n, generator, device)
                for s in self.stages[:stage_limit or len(self.stages)]]

    def forward(self, x: torch.Tensor, stage_limit: int | None = None,
                drop: list | None = None) -> torch.Tensor:
        """``[N, H, W, 3]`` -> NHWC features of the last stage run."""
        stage_limit = stage_limit or len(self.stages)
        if stage_limit > len(self.stages):
            raise ValueError(f"stage_limit={stage_limit} but {len(self.stages)} stages built")
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        for i in range(stage_limit):
            d = drop[i] if drop is not None else None
            if self.use_checkpoint and self.training and (
                    self.remat_stages is None or i in self.remat_stages):
                x = _remat(self.stages[i], x, d)
            else:
                x = self.stages[i](x, d)
        return x.permute(0, 2, 3, 1)

    def forward_stage3(self, x: torch.Tensor, drop: list | None = None) -> torch.Tensor:
        """MAE feature tap: ``[N, 112, 112, 3]`` frames -> ``[N, 14, 14, 384]``."""
        return self(x, stage_limit=3, drop=drop)


def tiny_vit_21m_variant(use_checkpoint: bool = True, dtype: torch.dtype = torch.float32,
                         attn_impl: str | None = None, **kwargs) -> TinyViT:
    """dims [96,192,384,576] / depths [2,2,6,2] / heads [3,6,12,18]
    (ref: src/models/tiny_vit.py:188-191)."""
    return TinyViT(use_checkpoint=use_checkpoint, dtype=dtype, attn_impl=attn_impl, **kwargs)


class TinyViTBackbone(nn.Module):
    """``(frames, drop) -> (feat_map, emb)`` adapter over the TinyViT encoder,
    so that ``VideoClassifier`` can ride a pipeline-B MAE-pretrained encoder
    (the JAX package's ``models/tiny_vit.TinyViTBackbone``).

    The inner TinyViT is named ``encoder`` and built with ``stage_limit``
    stages, so a pipeline-B encoder checkpoint (``encoder.*``, the port's
    ``entry/train_ssl_mae`` save path) lands on ``backbone.encoder.*`` key for
    key at the pretraining tap (3); 4 adds a randomly initialized last stage.
    Stochastic depth is TinyViT's default ramp (0.1 over all 12 blocks), as
    the JAX backbone passes no rate. ``emb`` is the mean of the last stage's
    feature map over H and W, in the compute dtype.
    """

    def __init__(self, stage_limit: int = 3,
                 embed_dims: Sequence[int] = (96, 192, 384, 576),
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 attn_impl: str | None = None):
        super().__init__()
        self.stage_limit = stage_limit
        self.embed_dim = int(embed_dims[stage_limit - 1])
        self.encoder = TinyViT(embed_dims=tuple(embed_dims), use_checkpoint=use_checkpoint,
                               dtype=dtype, attn_impl=attn_impl, num_stages=stage_limit)

    def draw_drop_path(self, n: int, generator: torch.Generator, device=None) -> list:
        """The encoder's stochastic-depth decisions for ``n`` frames."""
        return self.encoder.draw_drop_path(n, generator, device)

    def forward(self, x: torch.Tensor, drop: list | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.encoder(x, stage_limit=self.stage_limit, drop=drop)
        return feat, feat.mean(dim=(1, 2))
