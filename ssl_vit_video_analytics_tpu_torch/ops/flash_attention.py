"""Flash attention over packed heads: the Hopper kernels K1 (forward) and
K2 (backward), their plain PyTorch versions, and the autograd Function that
joins them.

Counterpart of ``ssl_vit_video_analytics_tpu/ops/flash_attention.py``. The
TPU module tiles for VMEM and the MXU's 128 lanes (``_plan``, ``_gbatch``,
``_groups``, ``_expand_heads``); none of that carries over. The Hopper
kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) pick their own tiles:
K1 walks K/V with an online softmax, so it has no sequence-length ceiling
and needs no padding; K2 splits the backward into a dK/dV pass over key
tiles and a dQ pass over query tiles, so that no two CTAs write one output.
The dtype picks the kernel: bf16 runs on the tensor cores (``mma.sync``),
fp32 on the CUDA cores. Like the JAX kernels, which pack heads into
128-lane groups and scale by ``d_real``, they take any head dim d >= 1,
with the scale ``1/sqrt(d)`` of the real d. Up to the largest of
:data:`KERNEL_WIDTHS` each kernel is built for those widths and runs a d at
the least width that holds it, with the columns past d zero in shared
memory. Above it the wide kernels cut d into chunks of :data:`WIDE_COLS`
columns and the output's columns into groups of up to :data:`WIDE_GROUP`
columns, one CTA per (row tile, group): S (and dP) are summed over every
chunk once per tile pair and group, so up to d = 512 exactly once. bf16
tiles are staged by 16-byte ``cp.async`` copies (the wide kernels: by the
TMA) where d is a multiple of 8 (hence :func:`check_alignment`), else
element by element; no input is copied or padded in device memory.

Layout is the JAX package's: q ``[B, Lq, H*d]``, k/v ``[B, Lk, H*d]``, head
``h`` owns columns ``[h*d, (h+1)*d)``. The thirds of a fused qkv projection
are passed as strided views (row stride ``3*H*d``) without a copy.

Dispatch is by device only: a CPU tensor goes through the plain version; a
CUDA tensor launches the kernel or raises. There is no fallback from a
kernel to its plain version. :class:`FlashAttention` (the counterpart of
``_make_core``'s ``jax.custom_vjp``) runs K1 forward and K2 backward, or,
with ``impl="plain"``, the plain forward and the plain backward.

The kernels are built by :mod:`.kernel_build` at first use, with every other
kernel source of the port, into ``build/kernels/`` at the repo root, and
loaded with ``ctypes``.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from ..utils import tracing
from . import kernel_build

# the widths the kernels are built for (csrc/flash_mma.cuh, kernel_width);
# a head dim up to the largest runs at the least one that holds it, a wider
# one on the wide kernels, in chunks of WIDE_COLS and column groups of
# WIDE_GROUP (flash_mma.cuh, kWideCols and kGroupChunks)
KERNEL_WIDTHS = (32, 40, 48, 64, 96, 128, 256)
WIDE_COLS = 64
WIDE_GROUP = 8 * WIDE_COLS
# the least rows of a row tile of any wide kernel (K2's bf16 kernels and
# fp32 dK/dV: 32; K1 and fp32 dQ: 64)
WIDE_TILE_ROWS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# CTAs of one launch, all in grid.x
_MAX_GRID_X = 2**31 - 1
_ALIGN_BYTES = 16

# K1 launches in this process (one per launch, added where it launches)
launches = tracing.counter("flash_fwd.launches", launches=True)
# K2 calls in this process (one per call of the wrapper that launches its
# two kernels, dK/dV and dQ, added where it launches them)
bwd_launches = tracing.counter("flash_bwd.launches", launches=True)
# of those, the launches and calls at a head dim above KERNEL_WIDTHS[-1]
# (the wide kernels)
wide_launches = tracing.counter("flash_fwd_wide.launches", launches=True)
wide_bwd_launches = tracing.counter("flash_bwd_wide.launches", launches=True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: fp32 logits, softmax, probabilities cast to the
    dtype of v, as ``_sdpa_xla`` computes them; per head, on packed inputs.

    Returns ``(out [B, Lq, H*d] in q's dtype, lse [B, Lq, H] fp32)``.
    """
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    H = num_heads
    d = HD // H
    qh = q.reshape(B, Lq, H, d).float()
    kh = k.reshape(B, Lk, H, d).float()
    logits = torch.einsum("blhd,bmhd->bhlm", qh, kh) * (1.0 / math.sqrt(d))
    lse = torch.logsumexp(logits, dim=-1)                      # [B, H, Lq]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v.reshape(B, Lk, H, d))
    return out.reshape(B, Lq, HD).to(q.dtype), lse.transpose(1, 2).contiguous()


def softmax_grad_rowsum(dout: torch.Tensor, out: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """``D = rowsum(dO * O)`` per head, fp32 ``[B, Lq, H]`` (the XLA op that
    ``_fa_bwd_impl`` computes before its kernel)."""
    B, Lq, HD = out.shape
    return (dout.float() * out.float()).reshape(B, Lq, num_heads, HD // num_heads).sum(-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                              num_heads: int
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: the explicit backward formulas in fp32, with ``lse``
    the logsumexp of the scaled logits (K1's convention):
    ``P = exp(S - lse)``, ``dP = dO V^T``, ``dS = P * (dP - D)``,
    ``dQ = dS K scale``, ``dK = dS^T Q scale``, ``dV = P^T dO``.

    Returns ``(dq, dk, dv)`` in the dtypes of ``q, k, v``.
    """
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    H = num_heads
    d = HD // H
    scale = 1.0 / math.sqrt(d)
    qh = q.reshape(B, Lq, H, d).float()
    kh = k.reshape(B, Lk, H, d).float()
    vh = v.reshape(B, Lk, H, d).float()
    doh = dout.reshape(B, Lq, H, d).float()
    delta = softmax_grad_rowsum(dout, out, H).transpose(1, 2)[..., None]  # [B, H, Lq, 1]
    s = torch.einsum("blhd,bmhd->bhlm", qh, kh) * scale
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("blhd,bmhd->bhlm", doh, vh)
    ds = p * (dp - delta)
    dq = torch.einsum("bhlm,bmhd->blhd", ds, kh) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qh) * scale
    dv = torch.einsum("bhlm,blhd->bmhd", p, doh)
    return (dq.reshape(B, Lq, HD).to(q.dtype), dk.reshape(B, Lk, HD).to(k.dtype),
            dv.reshape(B, Lk, HD).to(v.dtype))


def _check_kernel_args(q, k, v, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention takes packed [B, L, H*d] tensors")
    B, Lq, HD = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != HD:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if HD % num_heads:
        raise ValueError(f"H*d={HD} does not divide into {num_heads} heads")
    d = HD // num_heads
    if d == 0:
        raise ValueError("head dim 0: q, k and v have no columns")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} must have a contiguous last dim (stride "
                             f"{t.stride(2)}); pass the packed view, not a transpose")
    if grid_ctas(B, max(Lq, k.shape[1]), num_heads, d) > _MAX_GRID_X:
        raise ValueError(f"B={B} x H={num_heads} x L={max(Lq, k.shape[1])} at head dim {d} "
                         f"exceeds the kernel grid ({_MAX_GRID_X} CTAs)")
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    return B, Lq, k.shape[1], HD, d


def grid_ctas(B: int, L: int, H: int, d: int) -> int:
    """The most CTAs that any launch of K1 or K2 puts in ``grid.x`` for a
    sequence of L rows: row tiles x CTAs per row tile x H x B. Up to the
    largest width a row tile is at least 16 rows (the fp32 kernels at width
    256) and takes at most 2 CTAs (K2's dK/dV column halves at 256); above
    it at least :data:`WIDE_TILE_ROWS` rows, one CTA per column group of
    :data:`WIDE_GROUP` columns."""
    if d <= KERNEL_WIDTHS[-1]:
        rows, per_tile = 16, 2
    else:
        rows, per_tile = WIDE_TILE_ROWS, -(-d // WIDE_GROUP)
    return B * H * -(-L // rows) * per_tile


def _misalignment(t: torch.Tensor) -> tuple[int, list[int]]:
    """Bytes by which ``t``'s data pointer, and its batch and row strides
    (of dims longer than 1), miss a multiple of 16."""
    size = t.element_size()
    return (t.data_ptr() % _ALIGN_BYTES,
            [t.stride(i) * size % _ALIGN_BYTES for i in (0, 1) if t.size(i) > 1])


def check_alignment(**tensors: torch.Tensor) -> None:
    """Raise unless each tensor's data pointer, and its batch and row
    strides in bytes, are multiples of 16: where d is a multiple of 8 the
    bf16 kernels stage rows through shared memory in 16-byte ``cp.async``
    copies. The thirds of a fused qkv projection pass (offsets ``h*d*2``
    bytes, row stride ``3*H*d*2``, for every such d)."""
    for name, t in tensors.items():
        ptr, strides = _misalignment(t)
        if ptr or any(strides):
            raise ValueError(
                f"{name} must be {_ALIGN_BYTES}-byte aligned with batch and row strides "
                f"of whole {_ALIGN_BYTES}-byte chunks for the bf16 kernel: pointer {ptr} "
                f"bytes past, strides {tuple(t.stride())} x {t.element_size()} bytes")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh contiguous copy where the bf16 kernels could not
    read it (autograd may hand an expanded or offset gradient)."""
    ptr, strides = _misalignment(t)
    if ptr or any(strides) or t.stride(2) != 1:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check_staging(d: int, dtype: torch.dtype, **tensors: torch.Tensor) -> bool:
    """Whether the kernel stages these tensors' rows in 16-byte copies (bf16
    with d a multiple of 8; then they must pass :func:`check_alignment`, or
    this raises). Any other d, and fp32, is read element by element."""
    if dtype != torch.bfloat16 or d % 8:
        return False
    check_alignment(**tensors)
    return True


def _check_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {t.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(out [B, Lq, H*d], lse [B, Lq, H] fp32)`` over packed q/k/v.

    CPU tensors go through :func:`flash_attention_plain`. CUDA tensors
    launch the kernel on the current stream; anything the kernel does not
    take raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads)
    _check_cuda(q)
    B, Lq, Lk, HD, d = _check_kernel_args(q, k, v, num_heads)
    _check_staging(d, q.dtype, q=q, k=k, v=v)
    out = torch.empty((B, Lq, HD), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Lq, num_heads), dtype=torch.float32, device=q.device)
    if Lq == 0 or B == 0:
        return out, lse
    lib = kernel_build.build()["flash_fwd"].lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ssl_vit_flash_fwd(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Lq, Lk, num_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), 1.0 / math.sqrt(d), stream)
    if err != 0:
        msg = lib.ssl_vit_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cudaError {err})")
    launches.count += 1
    if d > KERNEL_WIDTHS[-1]:
        wide_launches.count += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        num_heads: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: ``(dq, dk, dv)`` in the input dtype, from K1's ``out`` and ``lse``
    and the output gradient ``dout``.

    CPU tensors go through :func:`flash_attention_bwd_plain`. CUDA tensors
    launch the kernel's two passes on the current stream; anything the
    kernel does not take raises.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, num_heads)
    _check_cuda(q)
    B, Lq, Lk, HD, d = _check_kernel_args(q, k, v, num_heads)
    if dout.shape != q.shape or out.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} and out "
                         f"{tuple(out.shape)} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Lq, num_heads) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [B, Lq, H] = {(B, Lq, num_heads)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if _check_staging(d, q.dtype, q=q, k=k, v=v):
        dout = _aligned(dout)
    elif dout.stride(2) != 1:
        dout = dout.contiguous()  # autograd may hand an expanded gradient
    lse = lse.contiguous()
    delta = softmax_grad_rowsum(dout, out, num_heads)
    dq = torch.empty((B, Lq, HD), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, HD), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Lk, HD), dtype=v.dtype, device=q.device)
    if Lq == 0 or B == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = kernel_build.build()["flash_bwd"].lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ssl_vit_flash_bwd(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, num_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
            1.0 / math.sqrt(d), stream)
    if err != 0:
        msg = lib.ssl_vit_flash_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_bwd launch failed: {msg} (cudaError {err})")
    bwd_launches.count += 1
    if d > KERNEL_WIDTHS[-1]:
        wide_bwd_launches.count += 1
    return dq, dk, dv


IMPLS = ("kernel", "plain")


class FlashAttention(torch.autograd.Function):
    """Attention over packed q/k/v with its own backward (the counterpart of
    ``_make_core``'s ``jax.custom_vjp``). Saves q, k, v, out and lse.

    ``impl="kernel"``: K1 forward, K2 backward (their plain versions for CPU
    tensors). ``impl="plain"``: the plain forward and plain backward on any
    device.
    """

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, impl: str):
        fwd = flash_attention_plain if impl == "plain" else flash_attention_fwd
        out, lse = fwd(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.impl = num_heads, impl
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.impl == "plain" else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, ctx.num_heads)
        return dq, dk, dv, None, None


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, impl: str = "kernel") -> torch.Tensor:
    """Attention output ``[B, Lq, H*d]`` over packed q/k/v (see module doc),
    differentiable through :class:`FlashAttention`."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (expected one of {IMPLS})")
    return FlashAttention.apply(q, k, v, num_heads, impl)
