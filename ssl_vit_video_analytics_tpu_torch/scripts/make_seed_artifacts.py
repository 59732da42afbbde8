"""Aggregate the seed-replicate sweep (counterpart of the JAX package's
``scripts/make_seed_artifacts.py``).

Merges the committed single-seed (seed=42) sweep CSV with the seed-43/44
replicate cells under results/sweep_r5_app/, then writes:

  docs/examples/csv/ssl_transfer_sweep_app_seeds.csv
      backbone,label_fraction,mode,seed,best_top1       (one row per run)
  docs/examples/csv/ssl_transfer_sweep_app_stats.csv
      per-cell mean +- sd over seeds, pooled Wilson 95% CI on val clips,
      and (per backbone x fraction) the ft_ssl - ft_random mean difference
      with a pooled two-proportion z — the quantified version of the
      "low-label crossover" claim.

The binomial model: each best_top1 on the n_val-clip val split is
correct = round(top1 * n_val) Bernoulli successes; seeds are pooled for the
CI (training-seed variance is REPORTED separately as the sd column, so both
noise sources are visible).

Usage: python -m ssl_vit_video_analytics_tpu_torch.scripts.make_seed_artifacts \\
           [--root results/sweep_r5_app]
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import math
import os
import re

from ssl_vit_video_analytics_tpu_torch.utils.io import write_csv

BACKBONE = {"A": "mobilevit_s+sslA", "B": "tinyvit+maeB"}


def wilson(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    if n == 0:
        return 0.0, 1.0
    p = k / n
    d = 1 + z * z / n
    c = p + z * z / (2 * n)
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (c - h) / d, (c + h) / d


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="results/sweep_r5_app")
    ap.add_argument("--base_csv", default="docs/examples/csv/ssl_transfer_sweep_app.csv")
    ap.add_argument("--docs", default="docs/examples/csv")
    ap.add_argument("--n_val", type=int, default=216,
                    help="val clips behind each best_top1 (app fixture: 216)")
    ap.add_argument("--name", default="ssl_transfer_sweep_app")
    args = ap.parse_args(argv)

    rows = []
    if os.path.exists(args.base_csv):
        with open(args.base_csv) as f:
            for r in csv.DictReader(f):
                rows.append({"backbone": r["backbone"],
                             "label_fraction": float(r["label_fraction"]),
                             "mode": r["mode"], "seed": 42,
                             "best_top1": float(r["best_top1"])})
    for path in sorted(glob.glob(os.path.join(args.root, "*_lab*_s*",
                                              "campaign_summary.json"))):
        tag = os.path.basename(os.path.dirname(path))  # e.g. A_lab05_s43
        m = re.match(r"([AB])_lab(\d+)_s(\d+)$", tag)
        if not m:
            continue
        fam, lab, seed = m.groups()
        with open(path) as f:
            best = json.load(f)["best_top1"]
        for mode, top1 in best.items():
            rows.append({"backbone": BACKBONE[fam],
                         "label_fraction": int(lab) / 100.0,
                         "mode": mode, "seed": int(seed),
                         "best_top1": round(float(top1), 6)})
    if not rows:
        print("no rows found")
        return

    os.makedirs(args.docs, exist_ok=True)
    seeds_csv = os.path.join(args.docs, f"{args.name}_seeds.csv")
    write_csv(seeds_csv, sorted(rows, key=lambda r: (
        r["backbone"], r["label_fraction"], r["mode"], r["seed"])),
        fieldnames=["backbone", "label_fraction", "mode", "seed", "best_top1"])
    print("wrote", seeds_csv, f"({len(rows)} rows)")

    # per-cell stats
    cells: dict[tuple, list[float]] = {}
    for r in rows:
        cells.setdefault((r["backbone"], r["label_fraction"], r["mode"]),
                         []).append(r["best_top1"])
    n = args.n_val
    stats = []
    for (bk, frac, mode), vals in sorted(cells.items()):
        k = sum(round(v * n) for v in vals)
        N = n * len(vals)
        lo, hi = wilson(k, N)
        mean = sum(vals) / len(vals)
        sd = (sum((v - mean) ** 2 for v in vals) / len(vals)) ** 0.5
        stats.append({"backbone": bk, "label_fraction": frac, "mode": mode,
                      "n_seeds": len(vals), "mean": round(mean, 6),
                      "sd": round(sd, 6), "pooled_ci_lo": round(lo, 6),
                      "pooled_ci_hi": round(hi, 6)})
    stats_csv = os.path.join(args.docs, f"{args.name}_stats.csv")
    write_csv(stats_csv, stats,
              fieldnames=["backbone", "label_fraction", "mode", "n_seeds",
                          "mean", "sd", "pooled_ci_lo", "pooled_ci_hi"])
    print("wrote", stats_csv)

    # crossover tests: ft_ssl vs ft_random per (backbone, fraction)
    print("\n=== ft_ssl - ft_random (pooled two-proportion z) ===")
    for bk in sorted({r["backbone"] for r in rows}):
        for frac in sorted({r["label_fraction"] for r in rows}):
            a = cells.get((bk, frac, "ft_ssl"))
            b = cells.get((bk, frac, "ft_random"))
            if not a or not b:
                continue
            ka = sum(round(v * n) for v in a)
            kb = sum(round(v * n) for v in b)
            na, nb = n * len(a), n * len(b)
            p = (ka + kb) / (na + nb)
            se = math.sqrt(p * (1 - p) * (1 / na + 1 / nb)) or 1e-9
            zval = (ka / na - kb / nb) / se
            print(f"  {bk:18s} frac={frac:4.2f}: "
                  f"ft_ssl {sum(a)/len(a):.4f} (n={len(a)}) - "
                  f"ft_random {sum(b)/len(b):.4f} (n={len(b)}) = "
                  f"{sum(a)/len(a)-sum(b)/len(b):+.4f}, z={zval:+.2f}")


if __name__ == "__main__":
    main()
