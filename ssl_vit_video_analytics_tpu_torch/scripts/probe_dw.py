"""Microbench: the 3x3 depthwise conv kernel P1 at TinyViT stage-0 shapes
(56x56 pixels, 384 hidden channels of an MBConv).

Counterpart of the JAX package's ``scripts/probe_dw.py``. ``check`` holds
the kernel to its plain version and to cuDNN's grouped conv in fp32 (TF32
off) at ``[2, 56*56, 384]``; ``bench`` times, on bf16 ``[BT, 56*56, 384]``:
the kernel (``ops.depthwise.dw3x3``) forward and on the input gradient's
arithmetic (the same conv with the taps flipped), its plain version, and
the library yardsticks the JAX probe timed with XLA: cuDNN's grouped conv
forward and its gradient to the input, on a channels-last view (timed here
only; the kernel's path never calls them), and a copy of x, which moves the
same bytes as the kernel and nothing else.

    python -m ssl_vit_video_analytics_tpu_torch.scripts.probe_dw [BT] [check|bench|all] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ssl_vit_video_analytics_tpu_torch.ops.depthwise import dw3x3, dw3x3_plain
from ssl_vit_video_analytics_tpu_torch.scripts import FP32_FLOP_PER_S, bound_ms, time_ms

H = W = 56
C = 384
CHECK_N = 2
TOL_CHECK = 1e-5  # fp32, nine terms in another order


def inputs(N: int, dtype: torch.dtype, device: torch.device, seed: int = 0
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [N, H*W, C]`` in ``dtype`` and taps ``w [9, C]`` fp32, drawn with
    numpy from ``seed`` as the JAX probe draws them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N, H * W, C), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((9, C), dtype=np.float32))
    return x.to(device=device, dtype=dtype), w.to(device)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """``[N, H*W, C]`` as an NCHW view in channels-last memory."""
    return x.view(x.shape[0], H, W, C).permute(0, 3, 1, 2)


def _conv_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Taps ``[9, C]`` as a grouped-conv weight ``[C, 1, 3, 3]``."""
    return w.t().reshape(C, 1, 3, 3).to(dtype)


def cudnn_fwd(x: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    return F.conv2d(_nchw(x), w4, padding=1, groups=C)


def cudnn_bwd_dx(gy: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """The input gradient as autograd asks cuDNN for it in training: with a
    channels-last input beside the output gradient. (``torch.nn.grad.
    conv2d_input`` passes a stride-0 stand-in for the input, whose layout
    sends cuDNN down another, far slower path.)"""
    g = _nchw(gy)
    return torch.ops.aten.convolution_backward(g, g, w4, None, (1, 1), (1, 1), (1, 1), False,
                                               (0, 0), C, (True, False, False))[0]


def bound(N: int, dtype: torch.dtype) -> tuple[float, str]:
    """P1's least time on an H100: x read once, out written once, taps read
    once; 9 FMAs (18 flops) per output element at the fp32 rate."""
    elems = N * H * W * C
    return bound_ms(2 * elems * torch.finfo(dtype).bits // 8 + 9 * C * 4, 18 * elems,
                    FP32_FLOP_PER_S)


def check(device: torch.device, log: Callable[[str], None] = print) -> dict:
    x, w = inputs(CHECK_N, torch.float32, device, seed=1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = dw3x3(x, w, H, W)
        ref_plain = dw3x3_plain(x, w, H, W)
        ref_cudnn = cudnn_fwd(x, _conv_weight(w, torch.float32))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    got4 = got.view(CHECK_N, H, W, C)
    err_plain = float((got - ref_plain).abs().max())
    err_cudnn = float((got4 - ref_cudnn.permute(0, 2, 3, 1)).abs().max())
    log(f"max|dw3x3 - plain| = {err_plain:.2e}  max|dw3x3 - cudnn| = {err_cudnn:.2e}")
    if not (err_plain <= TOL_CHECK and err_cudnn <= TOL_CHECK):
        raise AssertionError(f"dw3x3 disagrees: plain {err_plain}, cudnn {err_cudnn} "
                             f"> {TOL_CHECK}")
    return {"name": "check fp32", "N": CHECK_N, "err_plain": err_plain,
            "err_cudnn": err_cudnn, "tol": TOL_CHECK}


def bench(BT: int, device: torch.device, iters: int = 10,
          log: Callable[[str], None] = print) -> list[dict]:
    x, w = inputs(BT, torch.bfloat16, device)
    w4 = _conv_weight(w, torch.bfloat16)
    flipped = w.flip(0)  # the input gradient is the conv with the taps flipped
    b_ms, b_by = bound(BT, torch.bfloat16)
    rows = []
    for name, fn in (("dw3x3 fwd", lambda: dw3x3(x, w, H, W)),
                     ("dw3x3 bwd(dx)", lambda: dw3x3(x, flipped, H, W)),
                     ("plain shifted-sum fwd", lambda: dw3x3_plain(x, w, H, W)),
                     ("cudnn grouped conv fwd", lambda: cudnn_fwd(x, w4)),
                     ("cudnn grouped conv bwd(dx)", lambda: cudnn_bwd_dx(x, w4)),
                     ("copy of x (the bytes alone)", x.clone)):
        ms = time_ms(fn, device, iters)
        log(f"{name:44s} {ms:8.4f} ms  (H100 bound {b_ms:.4f} ms, {b_by})")
        rows.append({"name": name, "BT": BT, "dtype": "bfloat16", "ms": ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    return rows


def run(BT: int = 256, mode: str = "all", device: str | torch.device = "cuda",
        iters: int = 10, log: Callable[[str], None] = print) -> list[dict]:
    """The probe's rows: the check (``check``, ``all``) and the timings
    (``bench``, ``all``) on ``device``."""
    if mode not in ("check", "bench", "all"):
        raise ValueError(f"mode {mode!r}: expected check, bench or all")
    device = torch.device(device)
    rows = []
    if mode in ("check", "all"):
        rows.append(check(device, log))
    if mode in ("bench", "all"):
        rows += bench(BT, device, iters, log)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("BT", nargs="?", type=int, default=256, help="images (default 256)")
    ap.add_argument("mode", nargs="?", default="all", choices=("check", "bench", "all"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    rows = run(args.BT, args.mode, device)
    print(json.dumps({"device": str(device), "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
