"""SSL pipeline A CLI: EMA teacher-student MFM + VICReg + TOP (counterpart
of the JAX package's ``entry/train_ssl.py``; reference: src/train_ssl.py).

TemporalSSL (MobileViT-S per frame + a 4-layer temporal transformer),
warmup-cosine AdamW with the config's clip, the EMA teacher initialized as a
copy of the student, TOP on from ``ssl_objectives.top_start_epoch`` every
``top_every`` steps, ``ssl_metrics.csv`` and full checkpoints
``ssl_epoch_{e}`` (student, EMA, BatchNorm statistics, optimizer state;
step and epoch in the sidecar). The split is device-resident as
``dataset.device_resident`` says. Under ``torchrun`` the batch goes over a
``data`` mesh as the JAX entry resolves it (``common.setup_data_parallel``);
rank 0 alone writes the CSV and checkpoints.

    python -m ssl_vit_video_analytics_tpu_torch.entry.train_ssl \\
        --config configs/ssl_train.yaml --device cuda
"""
from __future__ import annotations

import os
import time

import torch

from ..models.temporal import TemporalSSL
from ..parallel import mesh as pmesh
from ..train.finetune_engine import init_model
from ..train.ssl_engine import make_ssl_step
from ..train.state import create_train_state, make_optimizer, warmup_cosine_schedule
from ..utils.checkpoint import save_checkpoint
from ..utils.io import append_csv_row, ensure_dir
from ..utils.metrics import format_metrics
from ..utils.prng import set_seed
from . import common

CSV_FIELDS = ["epoch", "total", "mfm", "var", "top"]


def build_model(cfg: dict, clip_len: int, dtype: torch.dtype) -> TemporalSSL:
    m = cfg["model"]
    return TemporalSSL(embed_dim=int(m.get("embed_dim", 256)),
                       layers=int(m.get("temporal_layers", 4)),
                       heads=int(m.get("temporal_heads", 4)), clip_len=clip_len, dtype=dtype)


def checkpoint_tree(state) -> dict[str, torch.Tensor]:
    """Student (params and BatchNorm statistics, the keys of its
    ``state_dict``: ``encoder.*`` is the MobileViT a finetune loads), the
    EMA teacher under ``ema.`` and the optimizer state under ``opt.``."""
    return {**state.model.state_dict(),
            **{f"ema.{k}": v for k, v in state.ema.items()},
            **{f"opt.{k}": v for k, v in state.tx.state_dict().items()}}


def run(cfg: dict, log=print, max_steps: int | None = None,
        device: str | torch.device | None = None, on_step=None) -> dict:
    """Train. ``device``: argument, else ``device.name``, else cuda.
    ``on_step(global_step, state, metrics)`` is called after every step."""
    device = common.init_distributed(cfg, device, log)
    mesh = common.setup_data_parallel(cfg, int(cfg["training"]["batch_size"]), log)
    if mesh is not None and not mesh.member:
        return {"steps": 0, "save_dir": cfg["training"].get("save_dir")}
    main = pmesh.is_main()
    seed = int(cfg.get("seed", 42))
    init_gen = set_seed(seed)
    dtype = common.compute_dtype_from(cfg, device)

    ds = common.dataset_from_cfg(cfg, common.split_path(cfg, cfg["dataset"]["train_split"]),
                                 "ssl", seed=seed)
    tr = cfg["training"]
    ssl = cfg["ssl_objectives"]
    B = int(tr["batch_size"])
    T = ds.clip_len
    steps_per_epoch = max(1, len(ds) // B)
    epochs = int(tr["epochs"])

    model = build_model(cfg, T, dtype)
    init_model(model, init_gen)
    model.to(device)
    pmesh.broadcast_module(model, mesh)
    log(f"[INFO] train_ssl: params={sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
        f"device={device} dtype={str(dtype).replace('torch.', '')}")

    sch_cfg = tr.get("scheduler", {}) or {}
    lr = float(tr["learning_rate"])
    if sch_cfg.get("enable", True):
        lr = warmup_cosine_schedule(lr, int(sch_cfg.get("warmup_epochs", 0)) * steps_per_epoch,
                                    epochs * steps_per_epoch,
                                    lr * float(sch_cfg.get("eta_min_ratio", 0.0)))
    # the reference clips only when the config sets the key
    # (src/train_ssl.py:258-259); ssl_train.yaml sets 1.0
    clip = tr.get("clip_grad_norm")
    tx = make_optimizer(model.parameters(), lr, weight_decay=float(tr.get("weight_decay", 0.05)),
                        grad_clip=None if clip is None else float(clip))
    # EMA teacher init = student
    state = create_train_state(model, tx, ema={n: p.detach().clone()
                                               for n, p in model.named_parameters()})
    ds = common.maybe_device_resident(cfg, ds, device, log)

    # two variants, with and without the TOP objective (the reference gates
    # TOP by epoch and step, ref: src/train_ssl.py:185,224)
    step_plain = make_ssl_step(model, ssl, with_top=False, compute_dtype=dtype, mesh=mesh)
    step_top = make_ssl_step(model, ssl, with_top=True, compute_dtype=dtype, mesh=mesh)
    top_start = int(ssl.get("top_start_epoch", 1))
    top_every = max(1, int(ssl.get("top_every", 1)))
    step_gen = torch.Generator(device=device).manual_seed(seed + 1)

    save_dir = tr.get("save_dir", "results/ema_ssl_vicreg")
    if main:
        ensure_dir(save_dir)
    save_every = int(tr.get("save_every", 10))
    log_interval = int(tr.get("log_interval", 20))

    global_step = 0
    running: dict = {}
    for epoch in range(1, epochs + 1):
        top_enabled = epoch >= top_start
        t_ep = time.perf_counter()
        for step, batch in enumerate(
                common.epoch_batches(ds, B, shuffle=True, seed=seed, epoch=epoch,
                                     device=device, mesh=mesh), 1):
            use_top = top_enabled and (step % top_every == 0)
            state, metrics = (step_top if use_top else step_plain)(state, batch, step_gen)
            global_step += 1
            for k, v in metrics.items():  # device scalars, fetched at the log
                running[k] = running.get(k, 0.0) + v
            running["n"] = running.get("n", 0) + 1
            if on_step is not None:
                on_step(global_step, state, metrics)
            if step % log_interval == 0:
                n = running["n"]
                avg = {k: float(v) / n for k, v in running.items() if k != "n"}
                log(f"[INFO] ep={epoch} step={step}/{steps_per_epoch} "
                    + format_metrics(avg)
                    + f" (top_on={'Y' if top_enabled else 'N'} every={top_every})")
            if max_steps is not None and global_step >= max_steps:
                break
        n = max(1, running.get("n", 1))
        epoch_avg = {k: float(v) / n for k, v in running.items() if k != "n"}
        log(f"[INFO] Epoch done. ep={epoch} " + format_metrics(epoch_avg)
            + f" ({time.perf_counter() - t_ep:.1f}s)")
        if main:
            append_csv_row(os.path.join(save_dir, "ssl_metrics.csv"), {
                "epoch": epoch,
                "total": round(epoch_avg.get("loss", 0.0), 6),
                "mfm": round(epoch_avg.get("mfm", 0.0), 6),
                "var": round(epoch_avg.get("var", 0.0), 6),
                "top": round(epoch_avg.get("top", 0.0), 6),
            }, fieldnames=CSV_FIELDS)
        running = {}
        if (epoch % save_every == 0 or epoch == epochs) and main:
            # {student, ema, opt} like the reference's periodic saves
            # (ref: src/train_ssl.py:354-362)
            path = save_checkpoint(save_dir, f"ssl_epoch_{epoch}", checkpoint_tree(state),
                                   meta={"has_opt_state": True, "step": state.step,
                                         "epoch": epoch})
            log(f"[INFO] saved checkpoint: {path}")
        if epoch % save_every == 0 or epoch == epochs:
            pmesh.barrier(mesh)  # the checkpoint is on disk for every rank
        if max_steps is not None and global_step >= max_steps:
            break
    return {"steps": global_step, "save_dir": save_dir}


def main():
    p = common.make_parser("EMA teacher-student SSL pretraining (pipeline A)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/ssl_train.yaml")
    logger = common.make_logger(cfg, "train_ssl")
    with pmesh.process_group_scope():
        run(cfg, log=logger.log, device=args.device)


if __name__ == "__main__":
    main()
