"""Pipeline-B (flagship VideoMAE) pretraining evidence on one card
(counterpart of the JAX package's ``scripts/mae_evidence.py``).

The SSL-transfer campaign covers pipeline A; this produces the matching
evidence for the flagship pipeline-B model at production shapes
(TinyViT-21M-variant stage-3 encoder + 3136-token decoder, T=16, 112x112,
bf16, tube mask 0.9): real multi-epoch loss/pred_std dynamics on the hard
synthetic fixture, plus orig|masked|recon triptychs from the trained decoder
(the reference's visualize_mae flow, src/visualize_mae.py:195-210 — its
encoder-only saves can't render these, so training.save_full is used).
Training runs the port's ``entry.train_ssl_mae`` on ``--device`` (default
cuda).

Outputs under --out (default results/mae_evidence):
  mae_pretrain_metrics.csv    per-epoch loss / pred_std / clips-per-s / mfu
  mae_pretrain_steps.csv      per-step loss / pred_std
  fig_mae_pretrain.png        loss + collapse-monitor curves
  recon_val_{i}.png           triptychs on VAL clips (never seen in pretrain)
  train.log                   full training log
  ckpt/ckpt_epoch_{N}.pt, ckpt/ckpt_full_epoch_{N}.pt

Without matplotlib the figure and the triptychs are not drawn and their
lines print ``None``.

Run (card):  python -m ssl_vit_video_analytics_tpu_torch.scripts.mae_evidence
Smoke (CPU): python -m ssl_vit_video_analytics_tpu_torch.scripts.mae_evidence --smoke --device cpu
"""
from __future__ import annotations

import argparse
import os
import re
import time

import torch

from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_hard_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.data.masking import get_tube_mask
from ssl_vit_video_analytics_tpu_torch.entry import common, train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.reporting.plotting import fig_mae_pretrain
from ssl_vit_video_analytics_tpu_torch.reporting.visualize import save_reconstruction_triptych
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import restore_checkpoint
from ssl_vit_video_analytics_tpu_torch.utils.config import load_config
from ssl_vit_video_analytics_tpu_torch.utils.io import ensure_dir, write_csv

STEP_RE = re.compile(
    r"ep=(\d+) step=(\d+)/(\d+) loss=([\d.na]+) pred_std=([\d.na]+) "
    r"(?:gnorm=\S+ )?clips/s=([\d.]+) mfu=([\d.]+)")
EPOCH_RE = re.compile(
    r"epoch (\d+) done in [\d.]+s loss=([\d.na]+)(?: loss_mean=([\d.na]+))?")


def write_metric_csvs(lines, out_dir):
    """Parse train-log lines into per-epoch and per-step CSVs.

    The per-step CSV exists because the interesting descent (init ~2.4 down
    to ~1.0) happens inside epoch 1; a per-epoch curve starts after it."""
    last_step = {}
    steps = []
    for ln in lines:
        m = STEP_RE.search(ln)
        if m:
            ep, st, spe = int(m.group(1)), int(m.group(2)), int(m.group(3))
            last_step[ep] = m.groups()[3:]
            steps.append({"global_step": (ep - 1) * spe + st,
                          "loss": m.group(4), "pred_std": m.group(5)})
    rows = []
    for ln in lines:
        m = EPOCH_RE.search(ln)
        if m:
            ep = int(m.group(1))
            st = last_step.get(ep, ("nan",) * 4)
            # 'loss' = EPOCH MEAN when the entry logs it: the last-step loss
            # is tube-mask sampling noise (sigma ~0.05)
            rows.append({"epoch": ep,
                         "loss": m.group(3) or m.group(2),
                         "loss_last": m.group(2), "pred_std": st[1],
                         "clips_per_s": st[2], "mfu": st[3]})
    csv_path = os.path.join(out_dir, "mae_pretrain_metrics.csv")
    write_csv(csv_path, rows,
              ["epoch", "loss", "loss_last", "pred_std", "clips_per_s", "mfu"])
    steps_path = os.path.join(out_dir, "mae_pretrain_steps.csv")
    write_csv(steps_path, steps, ["global_step", "loss", "pred_std"])
    print(f"[mae-evidence] wrote {csv_path} ({len(rows)} epochs), "
          f"{steps_path} ({len(steps)} step samples)", flush=True)
    return csv_path, steps_path


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="results/mae_evidence")
    p.add_argument("--data", default="/tmp/ssl_campaign/data",
                   help="hard-fixture root (reused if already generated)")
    p.add_argument("--classes", type=int, default=24)
    p.add_argument("--clips", type=int, default=48)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--nuisance", type=float, default=1.0,
                   help="fixture noise/appearance nuisance level; lower "
                        "values give visually cleaner reconstructions")
    p.add_argument("--appearance", type=float, default=0.0,
                   help="fixture appearance-signal strength (classes partly "
                        "appearance-coded; the regime where PER-FRAME MAE "
                        "features can transfer — the encoder never sees "
                        "cross-frame info, so motion-only classes are "
                        "untransferable by construction)")
    p.add_argument("--motion", type=float, default=1.0,
                   help="fixture motion-signal strength")
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--log_interval", type=int, default=1,
                   help="step-log interval; each logged step copies its "
                        "metrics to the host and waits for the card, so long "
                        "runs may want 2-5")
    p.add_argument("--raw_pixel", action="store_true",
                   help="train with ssl.norm_pix_loss=false (raw-pixel MSE); "
                        "norm-pix targets of noise-dominated synthetic patches "
                        "are irreducibly white noise, so raw-pixel runs give "
                        "the interpretable reconstruction visuals")
    p.add_argument("--device_resident", default=None,
                   help="dataset.device_resident override (true|false|auto|"
                        "chunked); on a card, auto keeps a split of up to 4 GB "
                        "wholly in device memory and rotates shards of a "
                        "larger one")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--triptychs_only", action="store_true",
                   help="skip training; re-render triptychs from the saved "
                        "full checkpoint under --out")
    p.add_argument("--replot", action="store_true",
                   help="skip training; regenerate CSVs + figure from the "
                        "existing train.log under --out")
    p.add_argument("--device", default=None,
                   help="torch device of the training and the triptychs "
                        "(default: cuda); --device cpu runs on the CPU")
    args = p.parse_args(argv)

    if args.smoke:
        args.classes, args.clips, args.epochs, args.batch = 4, 6, 2, 4
        S, T = 32, 4
    else:
        S, T = 112, 16

    t0 = time.time()
    splits = make_hard_synthetic_dataset(
        args.data, num_classes=args.classes, videos_per_class=args.clips,
        num_frames=T, image_size=S, seed=args.data_seed,
        nuisance=args.nuisance, appearance_signal=args.appearance,
        motion_signal=args.motion)
    print(f"[mae-evidence] dataset ready ({time.time() - t0:.0f}s)", flush=True)

    cfg = load_config("configs/ssl_mae.yaml", base="configs/base.yaml")
    cfg["device"] = {"compute_dtype": "float32" if args.smoke else "bfloat16"}
    cfg["dataset"].update(backend="packed", train_split=splits["train"],
                          val_split=splits["val"], clip_len=T, stride=1,
                          image_size=S)
    if args.device_resident is not None:
        cfg["dataset"]["device_resident"] = args.device_resident
    cfg["paths"] = {"log_dir": os.path.join(args.out, "logs"), "split_root": ""}
    if args.smoke:
        cfg["model"].update(embed_dims=[8, 16, 24, 32], decoder_embed_dim=16,
                            decoder_depth=1, decoder_num_heads=2)
    cfg["model"]["use_checkpoint"] = False
    if args.raw_pixel:
        cfg["ssl"]["norm_pix_loss"] = False
    # base.yaml's 200-epoch recipe keeps warmup_epochs=40; rescale the
    # schedule to this run's horizon so most of it is cosine, not warmup
    cfg["training"].update(epochs=args.epochs, batch_size=args.batch,
                           warmup_epochs=max(1, args.epochs // 12),
                           accumulation_steps=1,
                           save_dir=os.path.join(args.out, "ckpt"),
                           save_every=args.epochs, save_full=True,
                           # default 1: the init descent (loss ~2.4 -> ~1.0)
                           # happens within the first ~20 steps and would be
                           # invisible at the entry's default interval of 20
                           log_interval=args.log_interval)

    if args.triptychs_only:
        make_triptychs(args, cfg, splits, T, S)
        return
    if args.replot:
        with open(os.path.join(args.out, "train.log")) as f:
            lines = [ln.rstrip("\n") for ln in f]
        csv_path, steps_path = write_metric_csvs(lines, args.out)
        fig = fig_mae_pretrain(csv_path,
                               os.path.join(args.out, "fig_mae_pretrain.png"),
                               steps_csv=steps_path)
        print(f"[mae-evidence] wrote {fig}", flush=True)
        return

    ensure_dir(args.out)
    lines: list[str] = []
    with open(os.path.join(args.out, "train.log"), "a") as logf:
        def log(msg):
            print(msg, flush=True)
            logf.write(str(msg) + "\n")
            logf.flush()
            lines.append(str(msg))

        print("[mae-evidence] === pipeline-B MAE pretrain ===", flush=True)
        train_ssl_mae.run(cfg, log=log, device=args.device)

    csv_path, steps_path = write_metric_csvs(lines, args.out)
    fig = fig_mae_pretrain(csv_path, os.path.join(args.out, "fig_mae_pretrain.png"),
                           steps_csv=steps_path)
    print(f"[mae-evidence] wrote {fig}", flush=True)

    make_triptychs(args, cfg, splits, T, S)


def make_triptychs(args, cfg, splits, T, S, n_samples=3):
    """Reconstructions on VAL clips with the trained full checkpoint
    (entry.visualize_mae's flow, ref: src/visualize_mae.py:195-210). Clip
    ``i``'s tube mask comes from a ``torch.Generator`` seeded with ``i``
    (JAX: ``jax.random.key(i)``; the same law, other numbers)."""
    device = common.device_from(cfg, args.device)
    dtype = common.compute_dtype_from(cfg, device)
    model = train_ssl_mae.build_model(cfg, dtype)
    model.load_state_dict(restore_checkpoint(
        os.path.join(args.out, "ckpt", f"ckpt_full_epoch_{args.epochs}")))
    model.to(device).eval()

    ds = common.dataset_from_cfg(cfg, splits["val"], "ssl")
    ratio = float(cfg["ssl"].get("mask_ratio", 0.9))
    L = (S // 8) ** 2
    for i in range(n_samples):
        clip_u8 = ds.get_clip(i * max(1, len(ds) // n_samples))
        mask = get_tube_mask(torch.Generator(device=device).manual_seed(i), 1, T, L, ratio,
                             device)
        out = save_reconstruction_triptych(
            model, clip_u8, mask, 8,
            os.path.join(args.out, f"recon_val_{i}.png"), dtype,
            norm_pix=bool(cfg["ssl"].get("norm_pix_loss", False)))
        print(f"[mae-evidence] wrote {out}", flush=True)


if __name__ == "__main__":
    main()
