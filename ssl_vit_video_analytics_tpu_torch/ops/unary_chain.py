"""An n-step chain of one unary op in fp32 or bf16: the Hopper kernel P2
(``csrc/unary_chain.cu``), its plain PyTorch version, and the wrapper
between them.

Counterpart of the kernel that ``make_kernel`` builds in
``scripts/probe_exp.py``: an fp32 block is cast to the working type, one op
is applied ``n`` times as a data-dependent chain, and the result is written
in fp32. The ops and their constants are the JAX probe's ``OPS``, with
``gelu`` in ``jax.nn.gelu``'s default tanh form. In bf16 every elementary
operation of the expression is rounded to bf16, as JAX computes it op by op
(``F.gelu(approximate="tanh")`` rounds once and differs).

Dispatch is by device only: a CPU tensor goes through
:func:`unary_chain_plain`; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from ..utils import tracing
from . import kernel_build

OPS = ("exp", "tanh", "gelu", "fma")
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# P2 launches in this process (one per launch, added where it launches)
launches = tracing.counter("unary_chain.launches", launches=True)


# the JAX probe's constants, each taken in the working type
_CONSTANTS = {"exp": 0.12, "tanh_shift": 0.1, "fma_mul": 0.9991, "fma_add": 1e-4,
              "gelu_cube": 0.044715, "sqrt_2_over_pi": math.sqrt(2 / math.pi)}


def _apply(a: torch.Tensor, op: str, c: dict[str, float]) -> torch.Tensor:
    if op == "exp":
        return torch.exp(a * c["exp"])
    if op == "tanh":
        return torch.tanh(a + c["tanh_shift"])
    if op == "gelu":  # jax.nn.gelu(y), approximate=True, op by op
        y = a + c["tanh_shift"]
        cube = y * (y * y)
        return y * (0.5 * (1.0 + torch.tanh(c["sqrt_2_over_pi"] * (y + c["gelu_cube"] * cube))))
    return a * c["fma_mul"] + c["fma_add"]


def unary_chain_plain(x: torch.Tensor, n: int, dtype: torch.dtype, op: str) -> torch.Tensor:
    """Plain PyTorch P2: ``x`` (fp32) cast to ``dtype``, ``op`` applied
    ``n`` times, one PyTorch op per elementary operation; fp32 out."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (expected one of {OPS})")
    # Python floats holding the rounded values: PyTorch applies a scalar in
    # fp32 and rounds each result to the tensor's dtype
    c = {k: float(torch.tensor(v, dtype=dtype)) for k, v in _CONSTANTS.items()}
    a = x.to(dtype)
    for _ in range(n):
        a = _apply(a, op, c)
    return a.float()


def _check_kernel_args(x: torch.Tensor, n: int, dtype: torch.dtype, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (expected one of {OPS})")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"working type must be float32 or bfloat16, got {dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"n={n} out of range")


def unary_chain(x: torch.Tensor, n: int, dtype: torch.dtype, op: str) -> torch.Tensor:
    """P2: ``op`` applied ``n`` times to ``x`` in ``dtype``; fp32 out of
    x's shape (see module doc).

    CPU tensors go through :func:`unary_chain_plain`. CUDA tensors launch
    the kernel on the current stream; anything the kernel does not take
    raises.
    """
    if x.device.type == "cpu":
        return unary_chain_plain(x, n, dtype, op)
    if x.device.type != "cuda":
        raise ValueError(f"no unary-chain kernel for device {x.device}")
    _check_kernel_args(x, n, dtype, op)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = kernel_build.build()["unary_chain"].lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssl_vit_unary_chain(OPS.index(op), _DTYPE_CODES[dtype], x.data_ptr(),
                                      out.data_ptr(), x.numel(), n, stream)
    if err != 0:
        msg = lib.ssl_vit_unary_chain_error_string(err).decode()
        raise RuntimeError(f"unary_chain launch failed: {msg} (cudaError {err})")
    launches.count += 1
    return out
