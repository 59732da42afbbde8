"""LayerNorm over the last dim of bf16 or fp32 activations with fp32 weight
and bias: the Hopper kernels (``csrc/layer_norm.cu``), their plain PyTorch
version, and the autograd Function that joins them.

The function is flax's ``nn.LayerNorm(dtype=...)`` as the port has always
computed it: the activation taken to fp32 (exact), normalized with fp32
statistics and the fp32 affine, and rounded once to ``out_dtype``; the
gradients accumulate in fp32 and ``dx`` is rounded once to x's dtype. The
plain version spells that out as three passes (``x.float()``, torch's fp32
``layer_norm``, ``.to(out_dtype)``), and its backward as three more. The
kernels do it in one pass each way, reading x and writing y in x's dtype: 4
bytes an element forward and 6 backward in bf16, where the three passes move
about 20 and 32. Where ``out_dtype`` is not x's (no model of the port asks
for that), the fp32 kernels run on the exact fp32 copy and round once after. Weight and bias stay fp32: casting
them to bf16, so that a stock mixed-dtype LayerNorm would take them, would
lower the precision the configurations state.

The kernels replace no TPU kernel (the JAX package leaves LayerNorm to XLA,
which fuses the casts); they were added for the fp32 round trip. They are
bounded by bytes: one warp a row, the row held in registers (16-byte
vectors where the width, the row stride and the pointers allow, else
element by element), the forward two rows a warp at widths up to 16
elements a lane so that more bytes are in flight; mean and variance in two
passes over the registers. The backward is one pass over x and dy a row: ``dx`` from the
row's two sums, and each persistent block's fp32 sums of ``dγ`` and ``dβ``
over its rows, which a second small kernel adds up in a fixed order
(deterministic, no atomics). Widths up to :data:`MAX_WIDTH`.

Dispatch is observed, not chosen: a CPU tensor, or any tensor under a
``torch.compile`` or ``torch.export`` trace (as ``models.layers.use_prepared``
reads it), goes through :func:`layer_norm_plain`; a CUDA tensor launches the
kernels or raises. There is no fallback from a kernel to its plain version.
The forward launch allocates nothing inside the C function and never
synchronizes, so a CUDA graph captures it.

Traced (``utils/tracing.py``): each call is a ``layer_norm`` span, and its
backward a ``layer_norm.bwd`` span (``tracing.BackwardRange``). Counters:
``layer_norm.launches`` (forward kernel launches), ``layer_norm_bwd.launches``
(backward calls, each launching the row kernel and the reduction) and
``layer_norm.plain_calls`` (calls of the plain version), all launch counters,
so that a CUDA graph's replays add what they replay.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils import tracing
from . import kernel_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN_BYTES = 16
# the widest row the kernels hold in registers (32 elements a lane)
MAX_WIDTH = 1024

launches = tracing.counter("layer_norm.launches", launches=True)
bwd_launches = tracing.counter("layer_norm_bwd.launches", launches=True)
plain_calls = tracing.counter("layer_norm.plain_calls", launches=True)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch LayerNorm over the last dim: x taken to fp32, torch's
    fp32 ``layer_norm`` with fp32 ``weight`` and ``bias``, the result cast to
    ``out_dtype``."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(out_dtype)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as ``[rows, D]`` rows of one stride with a contiguous last dim:
    a view where ``t`` allows one (a fused projection's slice), else a
    contiguous copy."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    try:
        return t.view(-1, t.shape[-1])
    except RuntimeError:
        return t.contiguous().view(-1, t.shape[-1])


def _vectorized(D: int, row_stride: int, x: torch.Tensor, *ts: torch.Tensor) -> bool:
    """Whether rows of ``D`` elements of x's dtype at ``row_stride`` load and
    store as 16-byte vectors from ``x`` and the tensors ``ts``."""
    vec = _ALIGN_BYTES // x.element_size()
    return (D % vec == 0 and row_stride % vec == 0
            and all(t.data_ptr() % _ALIGN_BYTES == 0 for t in (x, *ts)))


def _check_kernel_args(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       out_dtype: torch.dtype) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16 x, got {x.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernel writes float32 or bfloat16, not {out_dtype}")
    D = x.shape[-1] if x.dim() else 0
    if not 1 <= D <= MAX_WIDTH:
        raise ValueError(f"layer_norm kernel takes widths 1..{MAX_WIDTH}, got {D}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or t.dtype != torch.float32 or t.shape != (D,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{D}], got "
                             f"{None if t is None else (t.dtype, tuple(t.shape))}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch_error(lib, err: int, what: str) -> RuntimeError:
    msg = lib.ssl_vit_layer_norm_error_string(err).decode()
    return RuntimeError(f"layer_norm {what} failed: {msg} (cudaError {err})")


def layer_norm_fwd(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on rows ``x2 [R, D]`` (last dim contiguous):
    ``y [R, D]`` in ``out_dtype``, and each row's fp32 mean and 1/std. The
    kernel writes x's dtype: for another ``out_dtype`` it runs in fp32 on the
    exact fp32 copy of x and its result is rounded once after."""
    if x2.dtype != out_dtype:
        y, mean, rstd = layer_norm_fwd(x2.float(), weight, bias, eps, torch.float32)
        return y.to(out_dtype), mean, rstd
    R, D = x2.shape
    y = torch.empty((R, D), dtype=out_dtype, device=x2.device)
    mean = torch.empty(R, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(R, dtype=torch.float32, device=x2.device)
    if R == 0:
        return y, mean, rstd
    stride = x2.stride(0) if R > 1 else D
    vec = _vectorized(D, stride, x2, weight, bias)
    lib = kernel_build.build()["layer_norm"].lib
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.ssl_vit_layer_norm_fwd(
            _DTYPE_CODES[x2.dtype], int(vec), x2.data_ptr(), stride,
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            R, D, float(eps), stream)
    if err != 0:
        raise _launch_error(lib, err, "forward launch")
    launches.count += 1
    return y, mean, rstd


def layer_norm_bwd(x2: torch.Tensor, dy2: torch.Tensor, weight: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on rows ``x2`` and ``dy2`` ``[R, D]`` (last dims
    contiguous): ``dx`` in x's dtype and fp32 ``dweight``, ``dbias``. Where
    dy's dtype is not x's, the kernels run in fp32 on exact fp32 copies and
    dx is rounded once after."""
    if dy2.dtype != x2.dtype:
        dx, dw, db = layer_norm_bwd(x2.float(), dy2.float(), weight, mean, rstd)
        return dx.to(x2.dtype), dw, db
    R, D = x2.shape
    dev = x2.device
    dx = torch.empty((R, D), dtype=x2.dtype, device=dev)
    if R == 0:
        return dx, torch.zeros(D, device=dev), torch.zeros(D, device=dev)
    x_stride = x2.stride(0) if R > 1 else D
    if R > 1 and dy2.stride(0) != D:  # the kernel reads dy at a pitch of D
        dy2 = dy2.contiguous()
    vec = _vectorized(D, x_stride, x2, dy2, weight)
    codes = (_DTYPE_CODES[x2.dtype], int(vec))
    lib = kernel_build.build()["layer_norm"].lib
    with torch.cuda.device(dev):
        grid = lib.ssl_vit_layer_norm_bwd_grid(*codes, R, D)
        if grid <= 0:
            raise _launch_error(lib, -grid, "backward grid")
        partial = torch.empty((2, grid, D), dtype=torch.float32, device=dev)
        dwb = torch.empty((2, D), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssl_vit_layer_norm_bwd(
            *codes, x2.data_ptr(), x_stride, dy2.data_ptr(), weight.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(), grid,
            dwb.data_ptr(), R, D, stream)
    if err != 0:
        raise _launch_error(lib, err, "backward launch")
    bwd_launches.count += 1
    return dx, dwb[0], dwb[1]


class LayerNormFunction(torch.autograd.Function):
    """The kernels forward and backward. Saves x in its own dtype (a view
    where :func:`_rows` could take one), the fp32 weight and each row's mean
    and 1/std: never an fp32 copy of x."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        x2 = _rows(x)
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps, out_dtype)
        ctx.save_for_backward(x2, weight, mean, rstd)
        ctx.shape = x.shape
        return y.view(x.shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x2, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, _rows(dy), weight, mean, rstd)
        need = ctx.needs_input_grad
        return (dx.view(ctx.shape), dw if need[1] else None, db if need[2] else None,
                None, None)


def _layer_norm(x, weight, bias, eps, out_dtype):
    if x.device.type == "cpu" or torch.compiler.is_compiling():
        plain_calls.count += 1
        return layer_norm_plain(x, weight, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no layer_norm kernel for device {x.device}")
    _check_kernel_args(x, weight, bias, out_dtype)
    return LayerNormFunction.apply(x, weight, bias, eps, out_dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of ``x`` over its last dim with fp32 ``weight`` and
    ``bias``, fp32 statistics, the result in ``out_dtype`` (see module doc).

    CPU tensors, and every tensor under a compile or export trace, go
    through :func:`layer_norm_plain`. CUDA tensors launch the kernels on the
    current stream; anything the kernels do not take raises.
    """
    if not tracing.enabled():
        return _layer_norm(x, weight, bias, eps, out_dtype)
    bwd = None
    if torch.is_grad_enabled() and x.requires_grad:
        bwd = tracing.BackwardRange("layer_norm.bwd")
        x, = bwd.inputs(x)
    with tracing.span("layer_norm"):
        y = _layer_norm(x, weight, bias, eps, out_dtype)
    return bwd.outputs(y)[0] if bwd is not None else y
