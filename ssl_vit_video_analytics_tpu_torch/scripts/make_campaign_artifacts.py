"""Turn a finished ssl_transfer_campaign run into committed evidence:
figures from the campaign CSVs + CSV/figure copies under docs/examples
(counterpart of the JAX package's ``scripts/make_campaign_artifacts.py``).
Without matplotlib no figure is drawn: each ``figure:`` line prints None
and the CSVs are copied all the same.

Usage: python -m ssl_vit_video_analytics_tpu_torch.scripts.make_campaign_artifacts \\
           [--campaign results/ssl_transfer] [--docs docs/examples]
"""
from __future__ import annotations

import argparse
import os
import shutil

from ssl_vit_video_analytics_tpu_torch.reporting.plotting import (
    fig18_feature_privacy, fig_finetune_comparison, fig_ssl_dynamics,
    fig_statistical_analysis)

MODES = ("ft_ssl", "ft_random", "linear_probe", "two_stage")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--campaign", default="results/ssl_transfer")
    p.add_argument("--docs", default="docs/examples")
    args = p.parse_args(argv)

    figs_dir = os.path.join(args.campaign, "figures")
    os.makedirs(figs_dir, exist_ok=True)
    ssl_csv = os.path.join(args.campaign, "ssl", "ssl_metrics.csv")
    ft_csvs = {m: os.path.join(args.campaign, "finetune", m, "metrics.csv")
               for m in MODES}
    priv_csv = os.path.join(args.campaign, "privacy", "feature_privacy.csv")

    made = [
        fig_ssl_dynamics(ssl_csv, os.path.join(figs_dir, "fig_ssl_dynamics.png")),
        fig_finetune_comparison(
            ft_csvs, os.path.join(figs_dir, "fig_finetune_comparison.png")),
        fig_statistical_analysis(
            ft_csvs, os.path.join(figs_dir, "fig_statistical_analysis.png")),
        fig18_feature_privacy(
            priv_csv, os.path.join(figs_dir, "fig18_feature_privacy.png")),
    ]
    for f in made:
        print("figure:", f)

    # refresh the committed examples with the real campaign outputs
    csv_dst = os.path.join(args.docs, "csv")
    fig_dst = os.path.join(args.docs, "figures")
    os.makedirs(csv_dst, exist_ok=True)
    os.makedirs(fig_dst, exist_ok=True)
    copies = [(ssl_csv, os.path.join(csv_dst, "ssl_metrics.csv")),
              (priv_csv, os.path.join(csv_dst, "feature_privacy.csv"))]
    copies += [(ft_csvs[m], os.path.join(csv_dst, f"finetune_{m}_metrics.csv"))
               for m in MODES]
    copies += [(f, os.path.join(fig_dst, os.path.basename(f)))
               for f in made if f]
    for src, dst in copies:
        if os.path.exists(src):
            shutil.copyfile(src, dst)
            print("copied:", dst)
        else:
            print("MISSING:", src)


if __name__ == "__main__":
    main()
