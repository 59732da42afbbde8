"""Standalone evaluation CLI (counterpart of the JAX package's
``entry/evaluate.py``).

Loads a finetuned classifier (a port ``.pt``, with or without its suffix, or
a JAX ``.npz``), computes top-k over a split (padding-aware), times one batch
(p50 of 10 calls after 1 warm call, host clock, each ended by a host copy of
the logits), and writes one ``evaluate.csv`` row with the JAX entry's
columns.

    python -m ssl_vit_video_analytics_tpu_torch.entry.evaluate \\
        --config configs/finetune.yaml --ckpt results/finetune/two_stage/best \\
        --split UCF101_val.txt --device cuda
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..train import finetune_engine as eng
from ..utils.checkpoint import checkpoint_path, read_checkpoint
from ..utils.io import ensure_dir, write_csv
from ..utils.prng import set_seed
from . import common


def run(cfg: dict, ckpt: str | None, split: str | None, log=print,
        measure_latency: bool = True, device: str | torch.device | None = None) -> dict:
    """Evaluate ``ckpt`` on ``split`` (default ``dataset.val_split``).
    Returns ``{"acc", "csv"}``."""
    device = common.device_from(cfg, device)
    seed = int(cfg.get("seed", 42))
    set_seed(seed)
    dtype = common.compute_dtype_from(cfg, device)
    d = cfg["dataset"]
    split_file = common.split_path(cfg, split or d.get("val_split", d.get("split")))
    ds = common.dataset_from_cfg(cfg, split_file, "supervised", seed=seed + 999)
    ds = common.maybe_device_resident(cfg, ds, device, log)
    B = int(cfg.get("training", cfg.get("runtime", {})).get("batch_size", 8))

    model = eng.build_model(int(d["num_classes"]), int(cfg["model"]["embed_dim"]),
                            dtype=dtype,
                            backbone=str(cfg["model"].get("backbone", "mobilevit_s")),
                            backbone_kwargs=cfg["model"].get("backbone_kwargs"))
    # fixed seed 0 for the random init, as the JAX entry's jax.random.key(0)
    eng.init_model(model, torch.Generator().manual_seed(0))
    if ckpt and checkpoint_path(ckpt):
        model.load_state_dict(read_checkpoint(ckpt))
        log(f"[INFO] loaded {ckpt}")
    else:
        log(f"[WARN] checkpoint not found ({ckpt}); evaluating random weights")
    model.to(device)
    eval_step = eng.make_eval_step(model, compute_dtype=dtype)
    topk = tuple(cfg.get("evaluation", {}).get("topk", [1, 5]))

    t0 = time.perf_counter()
    acc = eng.evaluate(eval_step,
                       common.epoch_batches(ds, B, shuffle=False, seed=0, epoch=0,
                                            device=device, drop_last=False), ks=topk)
    wall = time.perf_counter() - t0

    lat_ms = ""
    if measure_latency:
        batch = common.first_batch(ds, B, device, drop_last=True)
        eval_step(batch).cpu()  # warm
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            eval_step(batch).cpu()
            times.append((time.perf_counter() - t0) * 1000)
        lat_ms = f"{float(np.median(times)):.3f}"

    row = {"split": split_file, "n_samples": len(ds),
           **{f"top{k}": f"{acc[f'top{k}']:.6f}" for k in topk},
           "p50_batch_latency_ms": lat_ms, "batch_size": B,
           "eval_seconds": f"{wall:.1f}", "ckpt": ckpt or ""}
    log("[INFO] " + " ".join(f"{k}={v}" for k, v in row.items() if k != "ckpt"))
    out_dir = ensure_dir(cfg.get("paths", {}).get("result_dir", "results"))
    out_csv = os.path.join(out_dir, "evaluate.csv")
    write_csv(out_csv, [row])
    log(f"[INFO] wrote {out_csv}")
    return {"acc": acc, "csv": out_csv}


def main():
    p = common.make_parser("Standalone checkpoint evaluation")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--split", type=str, default=None)
    p.add_argument("--no-latency", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/finetune.yaml")
    logger = common.make_logger(cfg, "evaluate")
    run(cfg, args.ckpt or cfg.get("model", {}).get("finetune_ckpt"),
        args.split, log=logger.log, measure_latency=not args.no_latency,
        device=args.device)


if __name__ == "__main__":
    main()
