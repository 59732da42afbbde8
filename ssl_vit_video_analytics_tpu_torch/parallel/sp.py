"""Sequence-parallel attention (counterpart of the JAX package's
``parallel/sp.py``).

Each rank of a ``seq`` mesh holds a contiguous block of the sequence (the
long clip's frames, so ``L/n`` of the decoder's tokens). Its queries attend
over the whole sequence: K and V are all-gathered along L, and K1 runs on
this rank's query shard (``Lq = L/n``, ``Lk = L``). The softmax is exact,
so the result is the single-device attention's up to reduction order. In
the backward K2 gives dQ for the shard and dK, dV for the whole sequence,
which the all-gather's backward reduce-scatters: each rank keeps the sum
over the ranks of the gradient of its own block.

Traffic per call at ``[B, L, H*d]`` on n ranks: ``2 (n-1)/n B L H d``
elements gathered forward and reduce-scattered backward.
"""
from __future__ import annotations

import torch

from ..ops.flash_attention import flash_attention_packed
from .collectives import all_gather


def sp_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, group, impl: str = "kernel") -> torch.Tensor:
    """Attention of this rank's queries ``q [B, L/n, H*d]`` over the
    group's whole sequence; ``k``, ``v`` are this rank's ``[B, L/n, H*d]``
    blocks. The thirds of a fused qkv arrive as strided views: the gather
    copies k and v into the contiguous buffers the collective needs and
    hands the kernel strided views of its output; ``q`` goes to the kernel
    as it is. Returns ``[B, L/n, H*d]``."""
    return flash_attention_packed(q, all_gather(k, 1, group), all_gather(v, 1, group),
                                  num_heads, impl)
