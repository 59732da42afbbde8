"""SSL-transfer evidence campaign and feature-privacy frontier on one card
(counterpart of the JAX package's ``scripts/ssl_transfer_campaign.py``).

The reference's core claim is SSL-pretrain -> finetune transfer
(ref: src/plotting.py:81-99 — ft_ssl vs ft_random 30-epoch curves on UCF101).
Without UCF101 this runs the strongest available proxy: a scaled,
non-trivial synthetic dataset (motion-coded classes, randomized appearance —
data/fixtures.make_hard_synthetic_dataset) through the port's pipelines at
production image size:

  1. pipeline-A SSL pretrain (EMA teacher-student MFM + VICReg + TOP) on the
     train split, labels unused (``entry.train_ssl``);
  2. finetune ft_ssl vs ft_random vs linear_probe at EQUAL budget from the
     SSL checkpoint, per-epoch val top-1 CSVs (``entry.train_finetune``);
  3. feature-privacy sigma x mask grid with the ft_random best checkpoint +
     attacker (reference protocol, ``entry.run_privacy``).

Every entry runs on ``--device`` (default: the entries' own, cuda); the
configs handed to them are the JAX script's.

Outputs under --out (default results/ssl_transfer):
  ssl/ssl_metrics.csv, finetune/{mode}/metrics.csv,
  privacy/feature_privacy.csv, campaign_summary.json

Run (card):  python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign
Smoke (CPU): python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign \\
                 --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time

from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_hard_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.data.splits import read_split, write_split
from ssl_vit_video_analytics_tpu_torch.entry import run_privacy, train_finetune, train_ssl


def _count_lines(path: str) -> int:
    with open(path) as f:
        return sum(1 for _ in f)


def label_subset(train_split: str, fraction: float, out_dir: str) -> tuple[str, int, int]:
    """A class-balanced subset of ``train_split`` (at least one clip a
    class, ``random.Random(123)``), written to ``out_dir/ft_train_subset.txt``.
    Returns its path, its clips and the split's clips."""
    items = read_split(train_split)
    by_class: dict[int, list] = {}
    for path, label in items:
        by_class.setdefault(label, []).append((path, label))
    rng = random.Random(123)
    keep = []
    for _, group in sorted(by_class.items()):
        rng.shuffle(group)
        keep += group[:max(1, int(len(group) * fraction))]
    out = os.path.join(out_dir, "ft_train_subset.txt")
    os.makedirs(out_dir, exist_ok=True)
    write_split(keep, out)
    return out, len(keep), len(items)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="results/ssl_transfer")
    p.add_argument("--data", default="/tmp/ssl_campaign/data")
    p.add_argument("--smoke", action="store_true", help="tiny smoke run")
    p.add_argument("--classes", type=int, default=24)
    p.add_argument("--clips", type=int, default=48, help="clips per class")
    p.add_argument("--nuisance", type=float, default=1.0,
                   help="fixture nuisance level (appearance/background noise)")
    p.add_argument("--motion", type=float, default=1.0,
                   help="fixture motion-signal strength")
    p.add_argument("--appearance", type=float, default=0.0,
                   help="fixture appearance-signal strength (0 = motion-only classes)")
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--seed", type=int, default=42,
                   help="training seed (init + batch order); vary with data "
                        "fixed for seed-replicate error bars")
    p.add_argument("--ssl_epochs", type=int, default=60)
    p.add_argument("--ft_epochs", type=int, default=30)
    p.add_argument("--ft_lr", type=float, default=1e-4)
    p.add_argument("--ft_head_lr", type=float, default=1e-3)
    p.add_argument("--ssl_ckpt", default=None,
                   help="reuse an existing SSL checkpoint (with --skip_ssl); "
                        "ssl_epoch_N names ssl_epoch_N.pt")
    p.add_argument("--backbone", default="mobilevit_s",
                   help="finetune backbone: mobilevit_s (pipeline-A ckpts) | "
                        "tinyvit (pipeline-B/C MAE encoder ckpts; pass the "
                        "encoder checkpoint via --ssl_ckpt --skip_ssl)")
    p.add_argument("--ft_augment", action="store_true",
                   help="enable on-device augmentation in the finetunes")
    p.add_argument("--ft_label_fraction", type=float, default=1.0,
                   help="fraction of train labels the finetunes may use "
                        "(class-balanced subsample; SSL always pretrains on "
                        "the FULL unlabeled train split — the label-efficiency "
                        "regime SSL targets)")
    p.add_argument("--skip_ssl", action="store_true")
    p.add_argument("--skip_privacy", action="store_true")
    p.add_argument("--device_resident", default=None,
                   help="override dataset.device_resident (auto|true|false|"
                        "chunked): on a card, auto keeps a split of up to 4 GB "
                        "wholly in device memory and rotates shards of a "
                        "larger one; 'true' keeps it whole up to 12 GB")
    p.add_argument("--modes", default="ft_ssl,ft_random,linear_probe")
    p.add_argument("--device", default=None,
                   help="torch device of every entry (default: the entries' "
                        "own, cuda); --device cpu runs on the CPU")
    args = p.parse_args(argv)

    if args.smoke:
        args.classes, args.clips, args.ssl_epochs, args.ft_epochs = 4, 6, 2, 2
        S, T, B = 32, 4, 4
        embed = 32
    else:
        S, T, B = 112, 16, 16
        embed = 256

    t0 = time.time()
    splits = make_hard_synthetic_dataset(
        args.data, num_classes=args.classes, videos_per_class=args.clips,
        num_frames=T, image_size=S, seed=args.data_seed,
        nuisance=args.nuisance, motion_signal=args.motion,
        appearance_signal=args.appearance)
    n_train, n_val = _count_lines(splits["train"]), _count_lines(splits["val"])
    print(f"[campaign] dataset: {n_train} train / {n_val} val clips, "
          f"{args.classes} classes, T={T}, {S}x{S} ({time.time()-t0:.0f}s)",
          flush=True)

    base = {
        "seed": args.seed,
        "device": {"compute_dtype": "float32" if args.smoke else "bfloat16"},
        "dataset": {"backend": "packed", "train_split": splits["train"],
                    "val_split": splits["val"], "num_classes": args.classes,
                    "clip_len": T, "stride": 1, "image_size": S,
                    **({"device_resident": args.device_resident}
                       if args.device_resident is not None else {})},
        "paths": {"log_dir": os.path.join(args.out, "logs"), "split_root": "",
                  "save_dir": os.path.join(args.out, "finetune")},
    }

    ssl_dir = os.path.join(args.out, "ssl")
    ssl_ckpt = args.ssl_ckpt or os.path.join(ssl_dir, f"ssl_epoch_{args.ssl_epochs}")
    if not args.skip_ssl:
        ssl_cfg = {
            **base,
            "model": {"embed_dim": embed, "temporal_layers": 4 if not args.smoke else 1,
                      "temporal_heads": 4 if not args.smoke else 2},
            "training": {"epochs": args.ssl_epochs, "batch_size": B,
                         "learning_rate": 5e-4, "weight_decay": 0.05,
                         "save_every": args.ssl_epochs, "save_dir": ssl_dir,
                         "clip_grad_norm": 1.0, "log_interval": 20,
                         "scheduler": {"enable": True, "warmup_epochs": 3}},
            # reference ssl_train.yaml knobs (mask .75, ema .996, var 25, TOP)
            "ssl_objectives": {"mask_ratio": 0.75, "mfm_weight": 1.0,
                               "ema_momentum": 0.996, "var_weight": 25.0,
                               "top_weight": 1.0, "top_start_epoch": 3,
                               "top_every": 2, "top_subsample": 0.5},
        }
        print("[campaign] === pipeline-A SSL pretrain ===", flush=True)
        train_ssl.run(ssl_cfg, log=print, device=args.device)

    ft_train_split = splits["train"]
    if args.ft_label_fraction < 1.0:
        ft_train_split, kept, total = label_subset(splits["train"], args.ft_label_fraction,
                                                   args.out)
        print(f"[campaign] finetune label budget: {kept}/{total} "
              f"clips ({args.ft_label_fraction:.0%}, class-balanced)", flush=True)

    results = {}
    for mode in [m for m in args.modes.split(",") if m]:
        ft_cfg = {
            **base,
            "dataset": {**base["dataset"], "train_split": ft_train_split},
            "model": {"embed_dim": embed, "backbone": args.backbone,
                      "pretrained_ssl": ssl_ckpt if mode != "ft_random" else None},
            "training": {"epochs": args.ft_epochs, "batch_size": B,
                         "learning_rate": args.ft_lr, "head_lr": args.ft_head_lr,
                         "weight_decay": 0.05, "log_interval": 50,
                         "stage1_epochs": max(1, args.ft_epochs // 3),
                         "augment": args.ft_augment},
            "evaluation": {"topk": [1, 5]},
        }
        print(f"[campaign] === finetune {mode} ({args.ft_epochs} ep) ===", flush=True)
        out = train_finetune.run(ft_cfg, mode=mode, log=print, device=args.device)
        results[mode] = out["best_top1"]
        print(f"[campaign] {mode}: best val top1 = {out['best_top1']:.4f}",
              flush=True)

    if not args.skip_privacy:
        # feature grid with the ft_random best ckpt (the utility model; the
        # port's finetune saves it as best.pt, which the entry resolves), on
        # the TRAIN split for sample count (reference uses its privacy split;
        # the protocol — attacker trained and evaluated on the same perturbed
        # set — is identical, run_privacy.py docstring)
        priv_cfg = {
            **base,
            "dataset": {**base["dataset"], "split": splits["train"]},
            "model": {"embed_dim": embed,
                      "finetune_ckpt": os.path.join(
                          base["paths"]["save_dir"], "ft_random", "best")},
            "runtime": {"batch_size": B},
            "visual_privacy": {"enabled": False},
            "feature_privacy": {"enabled": True,
                                # reference rows first, then the calibrated
                                # extension past the embedding per-dim std
                                # (sigma must move leakage)
                                "noise_sigmas": [0.0, 0.05, 0.1, 0.2,
                                                 0.5, 1.0, 2.0, 4.0],
                                "mask_ratios": [0.0, 0.2, 0.4],
                                "attacker_epochs": 10, "attacker_lr": 1e-3},
            "output": {"save_dir": os.path.join(args.out, "privacy")},
        }
        print("[campaign] === feature privacy grid ===", flush=True)
        run_privacy.run(priv_cfg, log=print, device=args.device)

    summary = {"best_top1": results, "n_train": n_train, "n_val": n_val,
               "minutes": round((time.time() - t0) / 60.0, 1)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "campaign_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[campaign] done: {json.dumps(summary)}", flush=True)
    return summary


if __name__ == "__main__":
    main()
