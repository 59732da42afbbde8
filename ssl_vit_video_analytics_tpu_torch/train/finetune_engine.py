"""Classifier construction and initialization (the inference part of the
JAX package's ``train/finetune_engine.py``; the four finetune modes and
their optimizers come with the finetune path, ROADMAP queue 1)."""
from __future__ import annotations

import torch
from torch import nn

from ..models.classifier import VideoClassifier
from ..models.layers import ConvBNAct
from ..models.mobilevit import MobileViTBackbone

# flax's lecun_normal: truncated normal (+-2 std) rescaled to unit variance
_TRUNC_STD_CORRECTION = 0.87962566103423978


def build_model(num_classes: int, embed_dim: int, dtype: torch.dtype = torch.float32,
                backbone: str = "mobilevit_s") -> VideoClassifier:
    """A ``VideoClassifier`` in eval mode with torch's default init (see
    :func:`init_model` for the flax-like seeded init)."""
    if backbone in ("tinyvit", "tinyvit_21m"):
        raise NotImplementedError(
            f"backbone={backbone!r} is not ported yet: TinyViTBackbone arrives with "
            "the finetune path (ROADMAP queue 1, item 9)")
    if backbone not in ("mobilevit_s", "mobilevit"):
        raise ValueError(f"[ERROR] Unknown backbone={backbone}")
    return VideoClassifier(MobileViTBackbone(embed_dim, dtype), num_classes).eval()


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD_CORRECTION
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize ``model`` in place as flax initializes the JAX model:
    lecun-normal conv/dense kernels, zero biases, unit BN/LN scales (zero BN
    scale where a ``ConvBNAct`` asks for it: residual MBConvs), BN running
    mean 0 and variance 1, and ``truncated_normal(0.02)`` (within +-0.04)
    for the MAE's position embeddings and mask token. Draws from
    ``generator``."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            _lecun_normal_(m.weight, fan_in, generator)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.weight.shape[1], generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        for name, p in m.named_parameters(recurse=False):
            if name in ("temporal_pos_embed", "spatial_pos_embed", "mask_token"):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
    for m in model.modules():  # after their BatchNorm2d children got scale 1
        if isinstance(m, ConvBNAct) and m.bn_zero_init:
            nn.init.zeros_(m.bn.weight)
    return model
