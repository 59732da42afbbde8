"""Collect the SSL-transfer label-fraction sweep (experiments/torch/
run_transfer_sweep.sh) into one summary CSV + figure, and copy the evidence
into docs/examples (counterpart of the JAX package's
``scripts/make_sweep_artifacts.py``; without matplotlib the figure line
prints None).

Walks <root>/{A,B}_lab*/campaign_summary.json (A = pipeline-A MobileViT SSL
checkpoint, B = pipeline-B TinyViT MAE checkpoint), merging in any earlier
full-label campaign results passed via --extra (label_fraction=1.0 rows).

Usage: python -m ssl_vit_video_analytics_tpu_torch.scripts.make_sweep_artifacts \\
           [--root results/sweep_r4]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

from ssl_vit_video_analytics_tpu_torch.reporting.plotting import fig_label_fraction_sweep
from ssl_vit_video_analytics_tpu_torch.utils.io import write_csv

BACKBONE = {"A": "mobilevit_s+sslA", "B": "tinyvit+maeB"}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="results/sweep_r4")
    p.add_argument("--docs", default="docs/examples")
    p.add_argument("--chance", type=float, default=1.0 / 24)
    p.add_argument("--name", default="ssl_transfer_sweep",
                   help="basename for the docs copies (e.g. "
                        "ssl_transfer_sweep_app for the appearance fixture)")
    p.add_argument("--extra", action="append", default=[],
                   help="family:frac:path of an earlier campaign_summary.json "
                        "to merge, e.g. A:1.0:results/ssl_transfer_v3_noclip/"
                        "campaign_summary.json")
    p.add_argument("--seed_csv", default=None,
                   help="an earlier sweep CSV whose rows are kept for any "
                        "backbone family NOT present under --root (e.g. the "
                        "committed docs CSV's pipeline-A rows when only the "
                        "B cells were re-run)")
    args = p.parse_args(argv)

    rows = []
    for path in sorted(glob.glob(os.path.join(args.root, "*_lab*",
                                              "campaign_summary.json"))):
        tag = os.path.basename(os.path.dirname(path))  # e.g. A_lab10
        family, lab = tag.split("_lab")
        frac = int(lab) / 100.0
        with open(path) as f:
            best = json.load(f)["best_top1"]
        for mode, top1 in best.items():
            rows.append({"backbone": BACKBONE.get(family, family),
                         "label_fraction": frac, "mode": mode,
                         "best_top1": round(float(top1), 6)})
    for spec in args.extra:
        family, frac, path = spec.split(":", 2)
        with open(path) as f:
            best = json.load(f)["best_top1"]
        for mode, top1 in best.items():
            rows.append({"backbone": BACKBONE.get(family, family),
                         "label_fraction": float(frac), "mode": mode,
                         "best_top1": round(float(top1), 6)})
    if args.seed_csv:
        import csv as _csv
        fresh = {r["backbone"] for r in rows}
        with open(args.seed_csv) as f:
            kept = [r for r in _csv.DictReader(f) if r["backbone"] not in fresh]
        for r in kept:
            rows.append({"backbone": r["backbone"],
                         "label_fraction": float(r["label_fraction"]),
                         "mode": r["mode"],
                         "best_top1": float(r["best_top1"])})
        print(f"seeded {len(kept)} rows from {args.seed_csv} "
              f"(families not re-run under {args.root})")
    if not rows:
        print("no campaign_summary.json found under", args.root)
        return 1

    rows.sort(key=lambda r: (r["backbone"], r["mode"], r["label_fraction"]))
    csv_path = os.path.join(args.root, "sweep_summary.csv")
    write_csv(csv_path, rows,
              ["backbone", "label_fraction", "mode", "best_top1"])
    fig = fig_label_fraction_sweep(
        csv_path, os.path.join(args.root, "fig_label_fraction_sweep.png"),
        chance=args.chance)
    print("csv:", csv_path)
    print("figure:", fig)

    csv_dst = os.path.join(args.docs, "csv", args.name + ".csv")
    shutil.copyfile(csv_path, csv_dst)
    if fig:
        shutil.copyfile(fig, os.path.join(args.docs, "figures",
                                          "fig_" + args.name + ".png"))
    print("docs copies refreshed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
