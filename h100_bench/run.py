"""Run one cell of the H100 benchmark of ``ssl_vit_video_analytics_tpu_torch``
once, and print its result as the last line of standard output.

    python3 h100_bench/run.py --workload b_pretrain.clip16 --seed 7 --seconds 30 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled tail of the window. Every run checks
what its timed path produced against the plain reference under
``h100_bench/reference/`` and prints each number compared beside its
limit, as its last lines on standard error and under ``checks`` in the
result. It needs as many CUDA devices as the cell asks for, and fails
without them; it fails as well if JAX or the JAX package was loaded.
"""
import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every kernel cache of the run at a fixed place inside the checkout (the
# port builds its own kernels into build/kernels/ there)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    from h100_bench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cell.seed, cell.seconds, cell.trace, cell.log = args.seed, args.seconds, bool(args.trace), log
    cell.t0 = T0
    res = harness.run_cell(cell)
    line = harness.result_line(cell, res)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
