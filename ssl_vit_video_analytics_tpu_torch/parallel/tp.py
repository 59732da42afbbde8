"""Tensor parallelism, Megatron-style (counterpart of the JAX package's
``parallel/tp.py``).

On a ``{"data": dp, "model": tp}`` mesh every ``layers.MultiHeadAttention``
and every dense ``layers.Mlp`` of the model is cut over the ``model``
line: the TinyViT encoder's attention blocks as well as the decoders', as
JAX's rules match them by path. The batch is split over ``data`` and whole
over ``model``.

- Attention is cut by WHOLE heads: the rank at model index r holds q, k
  and v of a contiguous block of heads, its rows of ``qkv`` laid out
  ``[q_r | k_r | v_r]`` (column parallel), and the projection's columns of
  those heads (row parallel). Its attention runs K1/K2 on its own heads
  through the packed entry. The heads split as evenly as whole heads go
  (6 heads over 4 ranks: 2, 2, 1, 1); a rank with no heads adds zero to
  the projection's all-reduce. JAX instead splits ``[q|k|v]``'s columns
  contiguously and runs XLA's attention under TP, since a ``pallas_call``
  cannot be partitioned.
- An MLP's first linear is cut by rows (hidden units, column parallel) and
  its second by columns (row parallel) where ``tp`` divides the hidden
  width; otherwise the MLP stays whole, as JAX's ``shard_state_tp`` falls
  back to replication.

A cut layer takes its input through ``f`` (``collectives.copy_to_group``)
and sums its output with ``g`` (``collectives.reduce_from_group``); the
row-parallel bias is added once, after the sum. Every replicated param
then gets the same whole gradient on every rank of the line.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.layers import Mlp, MultiHeadAttention
from .shard import cut_param


def head_split(num_heads: int, tp: int) -> list[tuple[int, int]]:
    """Each rank's heads ``[h0, h1)``: contiguous blocks as even as whole
    heads go, the larger ones first (an empty block where tp exceeds the
    head count)."""
    base, extra = divmod(num_heads, tp)
    out, h = [], 0
    for r in range(tp):
        n = base + (r < extra)
        out.append((h, h + n))
        h += n
    return out


def shard_attention(attn: MultiHeadAttention, group, tp: int, r: int) -> None:
    h0, h1 = head_split(attn.num_heads, tp)[r]
    d, hd = attn.head_dim, attn.num_heads * attn.head_dim
    own = torch.arange(h0 * d, h1 * d)
    rows = torch.cat([own + j * hd for j in range(3)])
    cut_param(attn.qkv, "weight", 0, rows)
    cut_param(attn.qkv, "bias", 0, rows)
    cut_param(attn.proj, "weight", 1, own)
    attn.local_heads, attn.tp_group = h1 - h0, group


def shard_mlp(mlp: Mlp, group, tp: int, r: int) -> None:
    hidden = mlp.fc1.out_features
    if hidden % tp:
        return
    k = hidden // tp
    own = torch.arange(r * k, (r + 1) * k)
    cut_param(mlp.fc1, "weight", 0, own)
    cut_param(mlp.fc1, "bias", 0, own)
    cut_param(mlp.fc2, "weight", 1, own)
    mlp.tp_group = group


def shard_model_tp(model: nn.Module, mesh) -> None:
    """Cut every attention and dense MLP of ``model`` over the mesh's
    ``model`` line (in place)."""
    group, tp, r = mesh.group("model"), mesh.size("model"), mesh.index("model")
    for m in list(model.modules()):
        if isinstance(m, MultiHeadAttention):
            shard_attention(m, group, tp, r)
        elif isinstance(m, Mlp):
            shard_mlp(m, group, tp, r)


def count_sharded(model: nn.Module) -> tuple[int, int]:
    """``(param leaves cut over 'model', all param leaves)`` for the
    entry's log line (JAX's ``count_sharded``; see ROADMAP §3 for where
    the port's count differs)."""
    params = list(model.parameters())
    return sum(hasattr(p, "shard") for p in params), len(params)
