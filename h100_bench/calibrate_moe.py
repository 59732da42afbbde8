"""Readings that the limits of ``b_pretrain.moe`` are set from, as
``calibrate.py`` takes them for the dense training cells, through the MoE
path (``paths/pixel_mae_moe_train.py``): sound runs over many seeds, the
control (the MoE reference with float8 operands in the program's place),
and planted faults. One JSON line a reading, on standard output.

    python3 h100_bench/calibrate_moe.py --seeds 101-110 --control 3 \\
        --fault half_batch,no_gate --faults 2
    python3 h100_bench/calibrate_moe.py --seeds 101 --no-sound --fault no_capacity --faults 1

The faults, each planted in the program under its timed path: ``half_batch``
(``calibrate.half_batch``), ``no_gate`` (every MoE layer's output without
its gate: the combine leaves out the token's router probability) and
``no_capacity`` (every expert's buffer holds the whole group: no token is
dropped).

A run of the benchmark never calls this; ``tests/test_h100bench_moe.py``
runs the same at a size the CPU holds.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WORKLOAD = "b_pretrain.moe"


def _moe_layers(prog) -> list:
    from ssl_vit_video_analytics_tpu_torch.models.layers import MoeMlp

    return [m for m in prog.model.modules() if isinstance(m, MoeMlp)]


def no_gate(prog) -> None:
    """Plant the fault: each MoE layer's output is divided by its gate, as
    if the combine had left the gate out."""
    for m in _moe_layers(prog):
        def forward(x, m=m, orig=m.forward):
            y, aux = orig(x)
            gate = m._route(x)[0].amax(-1).reshape(*y.shape[:-1], 1)
            return (y.float() / gate).to(y.dtype), aux

        m.forward = forward


def no_capacity(prog) -> None:
    """Plant the fault: each expert's buffer holds a whole group, so no
    token is dropped."""
    for m in _moe_layers(prog):
        def capacity(tokens, orig=m.capacity):
            G, S, _ = orig(tokens)
            return G, S, S

        m.capacity = capacity


def plant(prog, fault: str) -> None:
    from h100_bench import calibrate

    {"half_batch": calibrate.half_batch, "no_gate": no_gate,
     "no_capacity": no_capacity}[fault](prog)


def readings(cell, seeds, control: int, faults: list[str], n_faults: int, sound: bool = True):
    import torch

    from h100_bench import calibrate, inputs
    from h100_bench.paths import pixel_mae_moe_train as P
    from h100_bench.reference.common import Precision

    device = torch.device(cell.device)
    accum = int(cell.cfg["training"].get("accumulation_steps", 1))
    for k, seed in enumerate(seeds):
        for kind in (["sound"] if sound else []) + (faults if k < n_faults else []):
            cell.seed = seed
            prog = P.Program(cell, device)
            if kind != "sound":
                plant(prog, kind)
            gen = torch.Generator(device=prog.device).manual_seed(inputs.stream_seed(seed, 3))
            rec = P.checked_steps(prog, gen)
            cfg, w0, spe = prog.cfg, prog.weights0, prog.steps_per_epoch
            del prog
            calibrate._free(device)
            out = P.reference_follow(cfg, rec, w0, spe, device)
            name = "sound" if kind == "sound" else f"fault_{kind}"
            yield {"kind": name, "seed": seed, **P.compare(rec, out, w0, accum)}
            if kind == "sound" and k < control:
                ctl = P.reference_follow(cfg, rec, w0, spe, device, Precision("fp8"))
                yield {"kind": "control_fp8", "seed": seed, **P.compare(ctl, out, w0, accum)}
            del rec, out
            calibrate._free(device)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True, help="a range, e.g. 101-110")
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--fault", default="half_batch,no_gate",
                   help="faults to plant: half_batch, no_gate, no_capacity")
    p.add_argument("--faults", type=int, default=2, help="seeds that read each fault")
    p.add_argument("--sound", action=argparse.BooleanOptionalAction, default=True,
                   help="read sound runs (--no-sound: the faults alone)")
    args = p.parse_args()

    from h100_bench import calibrate, harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), WORKLOAD)
    cell.log = lambda m: print(m, file=sys.stderr, flush=True)
    t0 = time.time()
    faults = [f for f in args.fault.split(",") if f]
    for r in readings(cell, calibrate.seeds_of(args.seeds), args.control, faults, args.faults,
                      args.sound):
        r["workload"], r["elapsed_s"] = WORKLOAD, time.time() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
