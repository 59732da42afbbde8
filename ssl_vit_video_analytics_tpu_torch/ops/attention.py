"""Scaled dot-product attention with a selectable implementation.

Counterpart of ``ssl_vit_video_analytics_tpu/ops/attention.py``. The JAX
package's ``"xla"``/``"pallas"`` switch becomes ``"plain"``/``"kernel"``;
both go through the autograd Function ``flash_attention.FlashAttention``:

- ``kernel`` (the default): K1 forward and K2 backward on a CUDA tensor,
  their plain versions on a CPU tensor.
- ``plain``: the plain PyTorch forward and backward on any device. On a CUDA
  tensor it is taken only when a caller names it (tests, the kernel-vs-plain
  checks).

Layouts are the JAX package's: ``[B, L, H, Dh]`` for :func:`sdpa`, packed
``[B, L, H*Dh]`` for :func:`attention_packed`.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_packed


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, impl: str | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over packed ``[B, L, H*Dh]`` inputs;
    ``impl`` None is ``"kernel"``."""
    return flash_attention_packed(q, k, v, num_heads, impl or "kernel")


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         impl: str | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over ``[B, L, H, Dh]`` inputs."""
    B, Lq, H, d = q.shape
    out = attention_packed(q.reshape(B, Lq, H * d), k.reshape(B, k.shape[1], H * d),
                           v.reshape(B, v.shape[1], H * d), H, impl)
    return out.reshape(B, Lq, H, d)
