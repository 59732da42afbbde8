"""3x3 depthwise convolution over channels-last pixels: the Hopper kernel P1
(``csrc/dw3x3.cu``), its plain PyTorch version, and the wrapper between
them.

Counterpart of ``dw_roll`` in ``scripts/probe_dw.py``. The layout is the
JAX probe's: x ``[N, H*W, C]`` (fp32 or bf16, channels contiguous) and taps
``w [9, C]`` fp32, tap ``(dh+1)*3 + (dw+1)`` for the neighbour at
``(h+dh, w+dw)``. The taps are already in that layout on both sides, so no
weight converter is needed. The TPU kernel's sublane rolls, edge masks and
``G`` images per grid cell are VMEM tiling and are not parameters here; so
are the kernel's own tiles (8 output rows x up to the whole width x 64
bytes of channels, copied with their halo by the TMA into shared memory),
which ``csrc/dw3x3.cu`` sets from the shape.

Dispatch is by device only: a CPU tensor goes through
:func:`dw3x3_plain`; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import kernel_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VECTOR_BYTES = 16  # one thread loads 16 bytes of channels

# P1 launches in this process (one per launch, added where it launches)
launches = tracing.counter("dw3x3.launches", launches=True)


def dw3x3_plain(x: torch.Tensor, w: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch P1: the explicit shifted sum in fp32 over a zero-padded
    image, taps added in the kernel's (dh, dw) order; stored in x's dtype."""
    N, HW, C = x.shape
    xp = F.pad(x.float().reshape(N, H, W, C), (0, 0, 1, 1, 1, 1))
    taps = w.float()
    acc = torch.zeros((N, H, W, C), dtype=torch.float32, device=x.device)
    for dh in (-1, 0, 1):
        for dw in (-1, 0, 1):
            acc += xp[:, 1 + dh:1 + dh + H, 1 + dw:1 + dw + W] * taps[(dh + 1) * 3 + dw + 1]
    return acc.reshape(N, HW, C).to(x.dtype)


def _check_kernel_args(x: torch.Tensor, w: torch.Tensor, H: int, W: int) -> None:
    if x.dim() != 3 or x.shape[1] != H * W:
        raise ValueError(f"x must be [N, H*W, C] with H*W = {H * W}, got {tuple(x.shape)}")
    C = x.shape[2]
    if w.shape != (9, C) or w.dtype != torch.float32:
        raise ValueError(f"w must be fp32 [9, {C}], got {w.dtype} {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16 x, got {x.dtype}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    vec = _VECTOR_BYTES // x.element_size()
    if C % vec:
        raise ValueError(f"C={C} is not a multiple of {vec} ({_VECTOR_BYTES} bytes of "
                         f"{x.dtype})")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % _VECTOR_BYTES:
            raise ValueError(f"{name} must be contiguous and {_VECTOR_BYTES}-byte aligned")
    if max(x.shape[0], H, W, C) >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int sizes")


def dw3x3(x: torch.Tensor, w: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """P1: ``out [N, H*W, C]`` in x's dtype (see module doc).

    CPU tensors go through :func:`dw3x3_plain`. CUDA tensors launch the
    kernel on the current stream; anything the kernel does not take raises.
    """
    if x.device.type == "cpu":
        return dw3x3_plain(x, w, H, W)
    if x.device.type != "cuda":
        raise ValueError(f"no depthwise kernel for device {x.device}")
    _check_kernel_args(x, w, H, W)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = kernel_build.build()["dw3x3"].lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssl_vit_dw3x3(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                                out.data_ptr(), x.shape[0], H, W, x.shape[2], stream)
    if err != 0:
        msg = lib.ssl_vit_dw3x3_error_string(err).decode()
        raise RuntimeError(f"dw3x3 launch failed: {msg} (cudaError {err})")
    launches.count += 1
    return out
