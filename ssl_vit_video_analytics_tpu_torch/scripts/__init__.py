"""Scripts of the port: the counterparts of the JAX package's Pallas
microbenchmarks ``scripts/probe_dw.py`` (P1) and ``scripts/probe_exp.py``
(P2), each driving its Hopper kernel, the decoder head repack probe
(``probe_decoder_repack``), the step profiler, and the research campaigns
(``ssl_transfer_campaign``, ``mae_evidence``, ``r5_privacy_grid`` and the
artifact scripts ``make_{campaign,sweep,seed}_artifacts``).

    python -m ssl_vit_video_analytics_tpu_torch.scripts.probe_dw [BT] [check|bench|all]
    python -m ssl_vit_video_analytics_tpu_torch.scripts.probe_exp
    python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign --smoke --device cpu

Each runs on ``cuda`` unless ``--device cpu`` is given; on the CPU the
kernels' plain versions run and the times are the CPU's.
"""
from __future__ import annotations

import math
import time
from typing import Callable

import torch

# H100 SXM data-sheet rates, for the least time the card could take
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
# clock cycles per second of a spin on the stream (the H100 SXM's boost
# clock; at a lower clock the spin only lasts longer)
SPIN_CYCLES_PER_S = 1.98e9


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 10,
            warmup: int = 3, repeats: int = 1, queued: bool = False) -> float:
    """Mean milliseconds per call of ``fn`` after ``warmup`` calls: CUDA
    events around ``iters`` calls on a card, the host clock on the CPU;
    the least such mean of ``repeats`` windows. With ``queued`` each window
    on a card starts behind a spin on the stream that lasts twice the
    host's time to launch the window, so the events time the calls back to
    back: neither the host's cost per call nor a short stall of the host
    is counted."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / max(warmup, 1)
    best = math.inf
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            if queued:
                spin_s = min(2 * iters * host_s + 1e-3, 0.2)
                torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(stop) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and ops over the peak rate,
    in ms, and which of the two it is (``"bytes"`` or ``"operations"``)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
