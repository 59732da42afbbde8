"""Readings that the limits of a cell's comparisons are set from, at the
cell's own size: the numbers compared for sound runs of the program over
many seeds (the lower reading), for the control (the plain reference,
computed with float8 operands, in the program's place) and, for a training
cell, for a planted fault (half of each batch left out, the loss the mean
over the rest). One JSON line a reading, on standard output.

    python3 h100_bench/calibrate.py --workload b_pretrain.clip16 --seeds 101-112 \\
        --control 3 --fault 3
    python3 h100_bench/calibrate.py --workload serve_ee.b8 --seeds 201-212 --control 3 \\
        --batches 300
    python3 h100_bench/calibrate.py --workload serve_ee.b8 --seeds 7 --sweep 30,40,50

The last finds the rate the serving cell offers: the highest that the
system sustains, swept once on the card.

A run of the benchmark never calls this; ``tests/test_h100bench_control.py``
runs the same at a size the CPU holds.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def half_batch(prog) -> None:
    """Plant the fault: the step sees the first half of each batch (and of
    its masks and decisions) alone."""
    orig = prog.step_fn
    h = prog.B // 2

    def step(state, batch, gen, mask=None, drop=None):
        frames = h * prog.T
        cut = None if drop is None else [
            [None if k is None else (tuple(x[:frames] for x in k) if isinstance(k, tuple)
                                     else k[:frames]) for k in stage] for stage in drop]
        return orig(state, {"clip": batch["clip"][:h]}, gen,
                    mask=None if mask is None else mask[:h], drop=cut)

    prog.step_fn = step


def train_readings(cell, seeds, control: int, fault: int):
    import torch

    from h100_bench import inputs
    from h100_bench.paths import pixel_mae_train as P
    from h100_bench.reference.common import Precision

    device = torch.device(cell.device)
    for k, seed in enumerate(seeds):
        kinds = ["sound"] + (["fault_half_batch"] if k < fault else [])
        for kind in kinds:
            cell.seed = seed
            prog = P.Program(cell, device)
            if kind == "fault_half_batch":
                half_batch(prog)
            gen = torch.Generator(device=prog.device).manual_seed(inputs.stream_seed(seed, 3))
            rec = P.checked_steps(prog, gen)
            cfg, w0, spe = prog.cfg, prog.weights0, prog.steps_per_epoch
            del prog
            _free(device)
            out = P.reference_follow(cfg, rec, w0, spe, device)
            accum = int(cfg["training"].get("accumulation_steps", 1))
            yield {"kind": kind, "seed": seed, **P.compare(rec, out, w0, accum)}
            if kind == "sound" and k < control:
                ctl = P.reference_follow(cfg, rec, w0, spe, device, Precision("fp8"))
                yield {"kind": "control_fp8", "seed": seed, **P.compare(ctl, out, w0, accum)}
            del rec, out
            _free(device)


def serve_readings(cell, seeds, control: int, batches: int):
    import torch

    from h100_bench.paths import early_exit_serve as P
    from h100_bench.reference.common import Precision

    device = torch.device(cell.device)
    for k, seed in enumerate(seeds):
        cell.seed = seed
        prog = P.Program(cell, device)
        served = []
        with torch.inference_mode():
            for b in range(batches):
                _, logits, used = prog.serve()
                served.append((b % prog.batches_per_pass, logits.cpu(), used.cpu()))
        split, cfg, w0, B, thr, ee = (prog.split, prog.cfg, prog.weights0, prog.B,
                                      prog.threshold, prog.ee)
        del prog
        _free(device)
        ref_logits, ref_used = P.reference_serve(cfg, split, [b for b, _, _ in served], thr, ee,
                                                 w0, B, device)
        prog_logits = torch.cat([lg for _, lg, _ in served]).float()
        prog_used = torch.cat([u for _, _, u in served])
        yield {"kind": "sound", "seed": seed,
               **P.compare(prog_logits, prog_used, ref_logits, ref_used)}
        if k < control:
            c_logits, c_used = P.reference_serve(cfg, split, [b for b, _, _ in served], thr, ee,
                                                 w0, B, device, Precision("fp8"))
            yield {"kind": "control_fp8", "seed": seed,
                   **P.compare(c_logits, c_used, ref_logits, ref_used)}
        _free(device)


def sweep(cell, rates, seconds: float):
    """The open loop at each offered rate in turn, in one process: latency
    p50/p95, service p95, completed clips/s and how late the last batch
    started (a backlog that grows through the window)."""
    import torch

    from h100_bench import yardstick
    from h100_bench.paths import early_exit_serve as P

    prog = P.Program(cell, torch.device(cell.device))
    with torch.inference_mode():
        for _ in range(P.WARM_BATCHES):
            prog.serve()
        for rate in rates:
            win = P.open_loop(prog, rate, seconds)
            yield {"kind": "sweep", "seed": cell.seed, "rate_clips_per_s": rate,
                   "p50_ms": 1e3 * yardstick.percentile(win["latency"], 50),
                   "p95_ms": 1e3 * yardstick.percentile(win["latency"], 95),
                   "service_p95_ms": 1e3 * yardstick.percentile(win["service"], 95),
                   "done_clips_per_s": len(win["latency"]) * prog.B / win["window_s"],
                   "last_late_ms": 1e3 * win["late"][-1],
                   "batches": len(win["latency"])}


def seeds_of(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="a range, e.g. 101-112")
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--fault", type=int, default=3, help="training: seeds that read the fault")
    p.add_argument("--batches", type=int, default=300, help="serving: batches a seed serves")
    p.add_argument("--sweep", default="", help="serving: offered clips/s to sweep, e.g. 30,40")
    p.add_argument("--seconds", type=float, default=20.0, help="sweep: seconds a rate")
    args = p.parse_args()

    from h100_bench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), args.workload)
    cell.log = lambda m: print(m, file=sys.stderr, flush=True)
    seeds = seeds_of(args.seeds)
    t0 = time.time()
    if args.sweep:
        cell.seed = seeds[0]
        readings = sweep(cell, [float(r) for r in args.sweep.split(",")], args.seconds)
    elif "split_clips" in cell.traffic:
        readings = train_readings(cell, seeds, args.control, args.fault)
    else:
        readings = serve_readings(cell, seeds, args.control, args.batches)
    for r in readings:
        r["workload"], r["elapsed_s"] = args.workload, time.time() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
