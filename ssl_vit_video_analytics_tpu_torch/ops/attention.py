"""Scaled dot-product attention with a selectable implementation.

Counterpart of ``ssl_vit_video_analytics_tpu/ops/attention.py``. The JAX
package's ``"xla"``/``"pallas"`` switch becomes ``"plain"``/``"kernel"``;
both go through the autograd Function ``flash_attention.FlashAttention``:

- ``kernel`` (the default): K1 forward and K2 backward on a CUDA tensor,
  their plain versions on a CPU tensor.
- ``plain``: the plain PyTorch forward and backward on any device. On a CUDA
  tensor it is taken only when a caller names it (tests, the kernel-vs-plain
  checks).
- ``sp``: sequence parallel over the registered ``seq`` group
  (:func:`set_sp_group`, ``parallel/sp.py``): this rank's queries over the
  group's whole sequence, through the kernels. With no group registered
  (one device) it is ``kernel``, as JAX's ``resolve_impl`` falls back.

Layouts are the JAX package's: ``[B, L, H, Dh]`` for :func:`sdpa`, packed
``[B, L, H*Dh]`` for :func:`attention_packed`.

While tracing is on (``utils/tracing.py``), each call is an ``attn.fwd``
span, whatever the implementation, and its backward an ``attn.bwd`` span,
both with the attrs of :func:`attention_attrs`. The backward's range is
opened and closed from outside the call's autograd nodes, by identity
functions on its output and inputs, so that it holds the kernels those
nodes launch (K2's ctypes launches hang off the node itself):
``tracing.BackwardRange``.
"""
from __future__ import annotations

import torch

from ..parallel.sp import sp_attention_packed
from ..utils import tracing
from .flash_attention import flash_attention_packed

# The sequence-parallel group registered by the training entry
# (entry/common.setup_parallelism); modules built with attn_impl="sp" shard
# their attention over it (JAX's set_sp_mesh)
_SP_GROUP = None


def set_sp_group(group) -> None:
    """Register (or clear, with None) the ``seq`` process group."""
    global _SP_GROUP
    _SP_GROUP = group


def get_sp_group():
    return _SP_GROUP


def attention_attrs(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> dict:
    """The attrs of an ``attn.fwd`` or ``attn.bwd`` span: the call's shape
    over packed q/k and its dtype."""
    B, Lq, HD = q.shape
    return {"B": B, "Lq": Lq, "Lk": k.shape[1], "H": num_heads, "d": HD // num_heads,
            "dtype": q.dtype}


def _attention(q, k, v, num_heads, impl):
    if impl == "sp":
        if _SP_GROUP is not None:
            return sp_attention_packed(q, k, v, num_heads, _SP_GROUP)
        impl = None
    return flash_attention_packed(q, k, v, num_heads, impl or "kernel")


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, impl: str | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over packed ``[B, L, H*Dh]`` inputs;
    ``impl`` None is ``"kernel"``."""
    if not tracing.enabled():
        return _attention(q, k, v, num_heads, impl)
    attrs = attention_attrs(q, k, num_heads)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if grad:
        bwd = tracing.BackwardRange("attn.bwd", attrs)
        q, k, v = bwd.inputs(q, k, v)
    with tracing.span("attn.fwd", attrs):
        out = _attention(q, k, v, num_heads, impl)
    return bwd.outputs(out)[0] if grad else out


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         impl: str | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over ``[B, L, H, Dh]`` inputs."""
    B, Lq, H, d = q.shape
    out = attention_packed(q.reshape(B, Lq, H * d), k.reshape(B, k.shape[1], H * d),
                           v.reshape(B, v.shape[1], H * d), H, impl)
    return out.reshape(B, Lq, H, d)
