"""Supervised action-recognition finetune CLI (counterpart of the JAX
package's ``entry/train_finetune.py``; reference: src/train_finetune.py).

Four modes (ft_random / linear_probe / ft_ssl / two_stage) with two-stage
freeze -> unfreeze (a fresh optimizer at the boundary), per-group LRs, a
pipeline-A MobileViT or a pipeline-B TinyViT backbone (``model.backbone``,
loaded from ``model.pretrained_ssl``: a port ``.pt`` or a JAX ``.npz``),
best-top1 checkpoints with metric-encoded names
(``finetune_epoch_{e}_top1_{acc:.4f}.pt``, plus the ``best.pt`` alias), a
``metrics.csv`` per epoch, the JAX entry's log lines, and the opt-in
on-device augmentation of the train step (``training.augment``,
``ops/augment.py``). The split goes device-resident as
``dataset.device_resident`` says. Under ``torchrun`` the batch, and each
validation batch, go over a ``data`` mesh as the JAX entry resolves it
(``common.setup_data_parallel``; validation counts summed over the ranks);
rank 0 alone writes the CSV and checkpoints.

    python -m ssl_vit_video_analytics_tpu_torch.entry.train_finetune \\
        --config configs/finetune.yaml --mode two_stage --device cuda
"""
from __future__ import annotations

import os
import time

import torch

from ..ops.augment import augment_from_cfg
from ..parallel import mesh as pmesh
from ..train import finetune_engine as eng
from ..train.state import create_train_state
from ..utils.checkpoint import best_ckpt_name, checkpoint_path, read_checkpoint, save_checkpoint
from ..utils.io import append_csv_row, ensure_dir
from ..utils.prng import set_seed
from . import common


def run(cfg: dict, mode: str | None = None, log=print,
        device: str | torch.device | None = None, on_step=None) -> dict:
    """Train and validate every epoch. ``device``: argument, else
    ``device.name``, else cuda. ``on_step(global_step, state, metrics)`` is
    called after every step. Returns ``{"best_top1", "best_ckpt"}``."""
    device = common.init_distributed(cfg, device, log)
    mesh = common.setup_data_parallel(cfg, int(cfg["training"]["batch_size"]), log)
    if mesh is not None and not mesh.member:
        return {"best_top1": 0.0, "best_ckpt": None}
    main = pmesh.is_main()
    mode = eng.resolve_mode(cfg, mode)
    seed = int(cfg.get("seed", 42))
    init_gen = set_seed(seed)
    dtype = common.compute_dtype_from(cfg, device)
    log(f"[INFO] Finetune mode: {mode} (device={device}, "
        f"dtype={str(dtype).replace('torch.', '')})")

    d = cfg["dataset"]
    train_ds = common.dataset_from_cfg(cfg, common.split_path(cfg, d["train_split"]),
                                       "supervised", seed=seed)
    val_ds = common.dataset_from_cfg(cfg, common.split_path(cfg, d["val_split"]),
                                     "supervised", seed=seed + 999)

    tr = cfg["training"]
    B = int(tr["batch_size"])
    num_classes = int(d["num_classes"])

    backbone = str(cfg["model"].get("backbone", "mobilevit_s"))
    model = eng.build_model(num_classes, int(cfg["model"]["embed_dim"]), dtype=dtype,
                            backbone=backbone,
                            backbone_kwargs=cfg["model"].get("backbone_kwargs"))
    if backbone not in ("mobilevit_s", "mobilevit"):
        log(f"[INFO] backbone: {backbone} (MAE-pretrained transfer path)")
    eng.init_model(model, init_gen)

    if mode != "ft_random":
        ssl_path = cfg["model"].get("pretrained_ssl")
        if ssl_path and checkpoint_path(ssl_path):
            eng.load_pretrained_ssl(model, read_checkpoint(ssl_path))
            log(f"[INFO] Loaded SSL pretrain from {ssl_path}")
        elif ssl_path:
            # a path that does not exist fails hard, as the reference
            # (src/train_finetune.py:288-290): a silent random init would
            # pass random-init results off as SSL transfer
            raise FileNotFoundError(
                f"[ERROR] mode={mode} requires model.pretrained_ssl, but "
                f"{ssl_path!r} does not exist. Set model.pretrained_ssl=null "
                "explicitly to accept random init (smoke runs only).")
        else:
            log(f"[WARN] pretrained_ssl unset; mode={mode} continuing from random init")
    model.to(device)
    pmesh.broadcast_module(model, mesh)

    stage1_epochs = int(tr.get("stage1_epochs", 0))
    two_stage = mode == "two_stage"
    if two_stage and stage1_epochs <= 0:
        raise ValueError("[ERROR] two_stage requires training.stage1_epochs > 0")
    freeze_backbone = (mode == "linear_probe") or two_stage

    state = create_train_state(model, eng.build_finetune_tx(tr, mode, model, freeze_backbone))
    train_ds = common.maybe_device_resident(cfg, train_ds, device, log)
    val_ds = common.maybe_device_resident(cfg, val_ds, device, log)
    augment = augment_from_cfg(tr)
    if augment is not None:
        log("[INFO] on-device augmentation enabled (training.augment)")
    train_step = eng.make_train_step(model, compute_dtype=dtype, augment=augment, seed=seed,
                                     mesh=mesh)
    eval_step = eng.make_eval_step(model, compute_dtype=dtype)
    step_gen = torch.Generator(device=device).manual_seed(seed + 1)

    epochs = int(tr["epochs"])
    topk = tuple(cfg.get("evaluation", {}).get("topk", [1, 5]))
    log_interval = int(tr.get("log_interval", 20))
    save_dir = os.path.join(cfg.get("paths", {}).get("save_dir", "results/finetune"), mode)
    if main:
        ensure_dir(save_dir)

    best_top1, best_ckpt, global_step = 0.0, None, 0
    for epoch in range(1, epochs + 1):
        if two_stage and epoch == stage1_epochs + 1:
            log("[INFO] two_stage: unfreeze backbone and rebuild optimizer")
            # fresh moments, count and step, as the JAX entry's new TrainState
            state = create_train_state(model, eng.build_finetune_tx(
                tr, mode, model, freeze_backbone=False))

        log(f"[INFO] Epoch {epoch}/{epochs} started")
        t0 = time.perf_counter()
        losses = []  # device scalars, fetched once per epoch
        for step, batch in enumerate(
                common.epoch_batches(train_ds, B, shuffle=True, seed=seed, epoch=epoch,
                                     device=device, mesh=mesh), 1):
            state, metrics = train_step(state, batch, step_gen)
            losses.append(metrics["loss"])
            global_step += 1
            if on_step is not None:
                on_step(global_step, state, metrics)
            if step % log_interval == 0:
                log(f"[INFO] ep={epoch} step={step} loss={float(metrics['loss']):.4f} "
                    f"top1={float(metrics['top1']):.4f}")
        loss_sum = sum(torch.stack(losses).tolist()) if losses else 0.0
        dt = time.perf_counter() - t0
        log(f"[INFO] Epoch {epoch} done in {dt:.1f}s "
            f"avg_loss={loss_sum / max(len(losses), 1):.4f}")

        acc = eng.evaluate(eval_step,
                           common.epoch_batches(val_ds, B, shuffle=False, seed=seed, epoch=0,
                                                device=device, drop_last=False, mesh=mesh),
                           ks=topk, mesh=mesh)
        log("[INFO] val " + " ".join(f"top{k}={acc[f'top{k}']:.4f}" for k in topk))
        if main:
            append_csv_row(os.path.join(save_dir, "metrics.csv"), {
                "epoch": epoch, "mode": mode,
                "train_loss": round(loss_sum / max(len(losses), 1), 6),
                **{f"val_top{k}": round(acc[f"top{k}"], 6) for k in topk},
            }, fieldnames=["epoch", "mode", "train_loss"] + [f"val_top{k}" for k in topk])

        if acc["top1"] > best_top1:
            best_top1 = acc["top1"]
            name = best_ckpt_name("finetune", epoch, "top1", best_top1)
            best_ckpt = os.path.abspath(os.path.join(save_dir, f"{name}.pt"))
            if main:
                save_checkpoint(save_dir, name, model.state_dict())
                # stable alias consumed by configs/dynamic.yaml-style paths
                save_checkpoint(save_dir, "best", model.state_dict())
                log(f"[INFO] Saved checkpoint: {best_ckpt}")
            pmesh.barrier(mesh)  # the checkpoint is on disk for every rank

    return {"best_top1": best_top1, "best_ckpt": best_ckpt}


def main():
    p = common.make_parser("Supervised finetune")
    p.add_argument("--mode", type=str, default=None,
                   help="ft_random | linear_probe | ft_ssl | two_stage")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/finetune.yaml")
    logger = common.make_logger(cfg, f"finetune_{args.mode or 'cfg'}")
    with pmesh.process_group_scope():
        run(cfg, mode=args.mode, log=logger.log, device=args.device)


if __name__ == "__main__":
    main()
