"""Microbench: throughput of exp, tanh, gelu and FMA chains, in fp32 and
bf16, through the kernel P2.

Counterpart of the JAX package's ``scripts/probe_exp.py``. The block
(``rows x lanes`` fp32, by default 896 x 6272 = 5.62 M elements, twice a
decoder block) is read and written once per call while the op is applied
``n`` times in registers, so the slope of the time between ``n = lo`` and
``n = hi`` is the cost of one application, as the JAX probe takes it. At
``lo`` the call is mostly the block's traffic, which the chain hides at
``hi``, so that slope reads low for the cheapest ops; the slope between
``mid`` and ``hi``, both bound by operations, cancels the traffic and is
the one held to the bound. Each row has both slopes, the bound on an H100
and the plain PyTorch version's slope. The kernel's times are the least
of three windows of calls queued behind a spin on the stream: a short
chain takes less time on the card than its launch on the host, so an
unqueued window would time the host.

    python -m ssl_vit_video_analytics_tpu_torch.scripts.probe_exp [--device cpu] [--sass]
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ssl_vit_video_analytics_tpu_torch.ops import kernel_build
from ssl_vit_video_analytics_tpu_torch.ops.unary_chain import (
    DTYPES, OPS, unary_chain, unary_chain_plain)
from ssl_vit_video_analytics_tpu_torch.scripts import HBM_BYTES_PER_S, time_ms

ROWS, LANES = 896, 6272
LO, MID, HI = 4, 132, 516  # MID and HI - MID whole trips of the main loop
# H100 SXM: 132 SMs at 1.98 GHz; per clock and SM 16 MUFU results (ex2,
# rcp, tanh), 128 fp32 and 256 16-bit FMA-pipe results (CUDA C programming
# guide, compute capability 9.0)
SMS, CLOCK_HZ = 132, 1.98e9
MUFU_PER_CLOCK, FMA_PER_CLOCK = 16, 128
# the fewest (MUFU, FMA-pipe) operations per element and application, each
# multiply and add rounded on its own as the plain version rounds it, in
# fp32 FMA-pipe ops: exp = ex2 of a scaled input, tanh = one tanh.approx
# after the shift, gelu = one tanh and 9 multiplies and adds, fma = a
# multiply and an add. In bf16 a packed multiply or add serves two elements
# at the fp32 op's issue cost, so it counts half an op per element.
MIN_OPS = {torch.float32: {"exp": (1, 1), "tanh": (1, 1), "gelu": (1, 9), "fma": (0, 2)},
           torch.bfloat16: {"exp": (1, 0.5), "tanh": (1, 0.5), "gelu": (1, 4.5), "fma": (0, 1)}}
# kUnroll and kElems of csrc/unary_chain.cu: the main loop's body applies
# the op UNROLL times to each of a thread's ELEMS elements
UNROLL, ELEMS = 4, 8
# the mangled names of its kernels: unary_chain_{f32,bf16x2}_kernel<op>
_KERNEL = re.compile(r"unary_chain_(f32|bf16x2)_kernelILi(\d)EE")
# conversions to bf16 in SASS: one value each, and one packed pair each
CONVERSIONS = ("F2F.BF16.F32", "F2FP.")


def per_application_bound_ms(op: str, dtype: torch.dtype, numel: int) -> float:
    mufu, fma = MIN_OPS[dtype][op]
    return numel * max(mufu / MUFU_PER_CLOCK, fma / FMA_PER_CLOCK) / (SMS * CLOCK_HZ) * 1e3


def call_bound_ms(op: str, dtype: torch.dtype, numel: int, n: int) -> tuple[float, str]:
    """Least time of one call: the block read and written once, or ``n``
    applications at the pipes' rates, whichever is longer."""
    t_bytes = 2 * numel * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = n * per_application_bound_ms(op, dtype, numel)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block(rows: int, lanes: int, device: torch.device, seed: int = 0) -> torch.Tensor:
    """The fp32 input block, drawn with numpy from ``seed`` as the JAX
    probe draws it."""
    x = np.random.default_rng(seed).standard_normal((rows, lanes)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def run(rows: int = ROWS, lanes: int = LANES, lo: int = LO, hi: int = HI,
        device: str | torch.device = "cuda", iters: int = 30, plain_iters: int = 10,
        log: Callable[[str], None] = print, mid: int = MID) -> list[dict]:
    """One row per op and working type: the kernel's time at ``lo``,
    ``mid`` and ``hi`` applications, its per-application slopes (``lo`` to
    ``hi``, and ``mid`` to ``hi`` with its rate, bound and share of the
    bound), and the plain version's times and slope."""
    device = torch.device(device)
    x = block(rows, lanes, device)
    numel = x.numel()
    out = []
    for op in OPS:
        for dtype in DTYPES:
            t = {n: time_ms(lambda: unary_chain(x, n, dtype, op), device, iters,
                            repeats=3, queued=True)
                 for n in (lo, mid, hi)}
            p = {n: time_ms(lambda: unary_chain_plain(x, n, dtype, op), device,
                            plain_iters, warmup=1) for n in (lo, hi)}
            per = (t[hi] - t[lo]) / (hi - lo)
            per_ops = (t[hi] - t[mid]) / (hi - mid)
            plain_per = (p[hi] - p[lo]) / (hi - lo)
            rate = numel / (per_ops / 1e3) / 1e9 if per_ops > 0 else float("nan")
            bound = per_application_bound_ms(op, dtype, numel)
            name = str(dtype).replace("torch.", "")
            log(f"{op:5s} {name:9s} per-application {per_ops:9.6f} ms "
                f"-> {rate:8.2f} G/s, {bound / per_ops:6.1%} of the H100 bound "
                f"{bound:.6f} ms (t{lo}={t[lo]:.4f} t{mid}={t[mid]:.4f} t{hi}={t[hi]:.4f}; "
                f"from t{lo} {per:.6f} ms; plain {plain_per:.6f} ms)")
            out.append({"op": op, "dtype": name, "numel": numel, "lo": lo, "mid": mid,
                        "hi": hi, "t_lo_ms": t[lo], "t_mid_ms": t[mid], "t_hi_ms": t[hi],
                        "per_application_ms": per, "per_application_ops_ms": per_ops,
                        "rate_g_per_s": rate,
                        "bound_per_application_ms": bound,
                        "share_of_bound": bound / per_ops if per_ops > 0 else float("nan"),
                        "bound_hi_ms": call_bound_ms(op, dtype, numel, hi)[0],
                        "plain_t_lo_ms": p[lo], "plain_t_hi_ms": p[hi],
                        "plain_per_application_ms": plain_per})
    return out


def sass_loop_counts(library: str | Path) -> dict[str, dict[str, float]]:
    """:func:`loop_counts` of ``cuobjdump -sass`` of the built P2 library."""
    return loop_counts(kernel_build.sass(library))


def loop_counts(sass: str) -> dict[str, dict[str, float]]:
    """Instructions per element and application in the main loop of each P2
    kernel of a SASS listing: the longest backward branch of a kernel spans
    its main loop, whose body applies the op ``UNROLL * ELEMS`` times
    (``csrc/unary_chain.cu``). Keyed ``"op/dtype"``, by opcode."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        m = _KERNEL.search(chunk.split("\n", 1)[0])
        if not m:
            continue
        labels, insns = {}, []
        for line in chunk.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = None  # address of the next instruction
                continue
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);",
                            line)
            if not ins:
                continue
            addr = int(ins.group(1), 16)
            for k, v in labels.items():
                if v is None:
                    labels[k] = addr
            insns.append((addr, ins.group(2), ins.group(3)))
        loops = []
        for a, opcode, args in insns:
            if opcode.startswith("BRA"):
                t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", args)
                target = labels.get(t.group(1)) if t and t.group(1) else (
                    int(t.group(2), 16) if t else None)
                if target is not None and target < a:
                    loops.append((target, a))
        if not loops:
            continue
        start, end = max(loops, key=lambda se: se[1] - se[0])
        counts: dict[str, float] = {}
        for a, opcode, _ in insns:
            if start <= a <= end:
                counts[opcode] = counts.get(opcode, 0) + 1
        per = UNROLL * ELEMS
        name = f"{OPS[int(m.group(2))]}/{'bfloat16' if m.group(1) == 'bf16x2' else 'float32'}"
        out[name] = {k: v / per for k, v in sorted(counts.items())}
    return out


def conversions(counts: dict[str, dict[str, float]]) -> dict[str, dict[str, float]]:
    """Conversions to bf16 per element and application in each bf16 main
    loop of :func:`loop_counts`: ``F2F.BF16.F32`` and ``F2FP.*`` apart."""
    return {name: {prefix: sum(v for op, v in ops.items() if op.startswith(prefix))
                   for prefix in CONVERSIONS}
            for name, ops in counts.items() if name.endswith("/bfloat16")}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sass", action="store_true",
                    help="print the kernels' main-loop instructions per application "
                         "(cuobjdump), then the bf16 conversions among them, and exit")
    args = ap.parse_args(argv)
    if args.sass:
        counts = sass_loop_counts(kernel_build.build()["unary_chain"].path)
        print(json.dumps(counts, indent=1), flush=True)
        print(json.dumps({"bf16_conversions": conversions(counts)}), flush=True)
        return [counts]
    device = torch.device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    rows = run(device=device)
    print(json.dumps({"device": str(device), "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
