"""Ablation runner (counterpart of the JAX package's ``entry/ablations.py``;
reference: src/ablations.py).

Four grids — sampling (clip_len/stride/image_size), SSL objective weights,
privacy blur strength, dynamic-inference knobs (ref: src/ablations.py:63-70,
101-105, 147-151, 173-177) — each run as a subprocess of the corresponding
entry point. Unlike the reference, configs are NEVER rewritten on disk
(ref: :30-36 deep_update + write_yaml + finally-restore): every override goes
through the entry points' ``--set key.path=value`` flags, so concurrent
ablations can share a config tree safely. Writes ablation_index.json
(ref: :201-203). Each cell is a subprocess of the port's entry; ``--device``
goes on to it only when given (the entries run on the card by default, and
``--device cpu`` is how a run without one reaches them).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ..utils.io import ensure_dir

ENTRY = "ssl_vit_video_analytics_tpu_torch.entry"


def run(cmd_module: str, overrides: list[str], extra: list[str] = (),
        config: str | None = None, base: str | None = None, dry_run: bool = False,
        device: str | None = None) -> int:
    cmd = [sys.executable, "-m", f"{ENTRY}.{cmd_module}"]
    if config:
        cmd += ["--config", config]
    if base is not None:
        cmd += ["--base", base]
    if device:
        cmd += ["--device", device]
    for o in overrides:
        cmd += ["--set", o]
    cmd += list(extra)
    print("[ABLATION]", " ".join(cmd), flush=True)
    if dry_run:
        return 0
    return subprocess.call(cmd)


def _cap(args, grid):
    """Apply --max_per_group (None = full grid, ref runs all cells).

    0 means "run zero cells", not "run everything" — the falsy-n shortcut
    here once silently ran the FULL grid on --max_per_group 0."""
    n = getattr(args, "max_per_group", None)
    return list(grid) if n is None else list(grid)[:n]


def sampling_grid(args, index):
    """clip_len x stride x image_size sweep through finetune
    (ref: src/ablations.py:63-99)."""
    grid = [
        {"dataset.clip_len": 16, "dataset.stride": 2, "dataset.image_size": 112},
        {"dataset.clip_len": 32, "dataset.stride": 2, "dataset.image_size": 112},
        {"dataset.clip_len": 32, "dataset.stride": 4, "dataset.image_size": 112},
        {"dataset.clip_len": 32, "dataset.stride": 2, "dataset.image_size": 96},
    ]
    for g in _cap(args, grid):
        tag = f"SAMP_CL{g['dataset.clip_len']}_ST{g['dataset.stride']}_IM{g['dataset.image_size']}"
        ov = [f"{k}={v}" for k, v in g.items()]
        ov.append(f"paths.save_dir={os.path.join(args.out_dir, tag, 'finetune')}")
        code = run("train_finetune", ov, config=args.finetune_config,
                   base=args.base, dry_run=args.dry_run, device=args.device)
        index.append({"group": "sampling", "tag": tag, "overrides": ov, "exit": code})


def ssl_objective_grid(args, index):
    """SSL loss-weight ablations (ref: src/ablations.py:101-145)."""
    grid = [
        {"ssl_objectives.var_weight": 0.0},
        {"ssl_objectives.top_weight": 0.0},
        {"ssl_objectives.mask_ratio": 0.5},
        {"ssl_objectives.mask_ratio": 0.9},
    ]
    for g in _cap(args, grid):
        tag = "SSL_" + "_".join(f"{k.split('.')[-1]}{v}" for k, v in g.items())
        ov = [f"{k}={v}" for k, v in g.items()]
        ov.append(f"training.save_dir={os.path.join(args.out_dir, tag, 'ssl')}")
        code = run("train_ssl", ov, config=args.ssl_config,
                   base=args.base, dry_run=args.dry_run, device=args.device)
        index.append({"group": "ssl_objective", "tag": tag, "overrides": ov, "exit": code})


def privacy_grid(args, index):
    """Blur-strength sweep (ref: src/ablations.py:147-171)."""
    for k in _cap(args, (15, 31, 63)):
        tag = f"PRIV_BLUR{k}"
        ov = [f"visual_privacy.blur_kernel={k}",
              f"output.save_dir={os.path.join(args.out_dir, tag, 'privacy')}"]
        code = run("run_privacy", ov, config=args.privacy_config,
                   base=args.base, dry_run=args.dry_run, device=args.device)
        index.append({"group": "privacy", "tag": tag, "overrides": ov, "exit": code})


def dynamic_grid(args, index):
    """Dynamic knobs sweep (ref: src/ablations.py:173-199)."""
    grid = [
        {"dynamic.min_frames": 2},
        {"dynamic.min_frames": 8},
        {"dynamic.frame_step": 2},
    ]
    for g in _cap(args, grid):
        tag = "DYN_" + "_".join(f"{k.split('.')[-1]}{v}" for k, v in g.items())
        ov = [f"{k}={v}" for k, v in g.items()]
        ov.append(f"output.save_dir={os.path.join(args.out_dir, tag, 'dynamic')}")
        code = run("run_dynamic", ov, extra=["--mode", "early_exit"],
                   config=args.dynamic_config, base=args.base, dry_run=args.dry_run,
                   device=args.device)
        index.append({"group": "dynamic", "tag": tag, "overrides": ov, "exit": code})


GROUPS = {
    "sampling": sampling_grid,
    "ssl_objective": ssl_objective_grid,
    "privacy": privacy_grid,
    "dynamic": dynamic_grid,
}


def main():
    p = argparse.ArgumentParser(description="Ablation runner (override-based, no config rewriting)")
    p.add_argument("--groups", nargs="+", default=list(GROUPS), choices=list(GROUPS))
    p.add_argument("--out_dir", default="results/ablation_runs")
    p.add_argument("--base", default="configs/base.yaml")
    p.add_argument("--finetune_config", default="configs/finetune.yaml")
    p.add_argument("--ssl_config", default="configs/ssl_train.yaml")
    p.add_argument("--privacy_config", default="configs/privacy.yaml")
    p.add_argument("--dynamic_config", default="configs/dynamic.yaml")
    p.add_argument("--max_per_group", type=int, default=None,
                   help="run only the first N cells of each grid")
    p.add_argument("--dry_run", action="store_true",
                   help="print the subprocess commands without running")
    p.add_argument("--device", default=None,
                   help="torch device for every cell (default: each entry's own, cuda)")
    args = p.parse_args()

    ensure_dir(args.out_dir)
    index: list[dict] = []
    for g in args.groups:
        GROUPS[g](args, index)
    index_path = os.path.join(args.out_dir, "ablation_index.json")
    with open(index_path, "w") as f:
        json.dump(index, f, indent=2)
    print(f"[INFO] wrote {index_path} ({len(index)} runs)")


if __name__ == "__main__":
    main()
