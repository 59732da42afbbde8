"""SSL pipeline C CLI: feature-space token MAE (counterpart of the JAX
package's ``entry/train_mae.py``; reference: src/mae/train_mae.py).

The full four-stage TinyViT-21M per frame, its stage-4 map pooled to
``stage4_pool**2`` tokens, random or tube token masks at the epoch's ratio
(``mae.mask_ratio_schedule``), a 2-block decoder back to the encoder width
and a masked feature loss; warmup-cosine AdamW with betas (0.9, 0.95),
clipping, gradient accumulation and the non-finite skip; collapse
detection; full resume (params, BatchNorm statistics, optimizer moments and
counters, step, epoch, with a cfg-hash check); keep-last-N checkpoint GC;
``training.max_epochs_per_run`` segments. The split is device-resident as
``dataset.device_resident`` says. Under ``torchrun`` the multi-device knobs
are resolved as the JAX entry resolves them over its devices
(``common.setup_parallelism``: a ``data`` or ``seq`` mesh, or with
``device.model_parallel`` a ``data`` x ``model`` mesh over which every
attention and MLP is cut, ``parallel/tp.py``); rank 0 alone writes, and a
checkpoint (model and optimizer) is gathered whole, the file one device
writes, which a resume cuts onto the mesh again. Every ``mae.vis_every``
epochs rank 0 draws the first clip's token mask and masked-token error
(``reporting/visualize.save_mae_vis``, under ``output.dir/vis/``); a failed
picture is logged and training goes on, as in JAX. Under a ``model`` or
``seq`` mesh the forward needs every rank, so no picture is drawn there (one
warning).

Every step draws from a generator seeded by ``(seed, global step)``, not
from one stream, so a resumed run replays the masks, flips and drop-path
decisions of a run that was never interrupted.

    python -m ssl_vit_video_analytics_tpu_torch.entry.train_mae \\
        --config configs/mae_train.yaml --device cuda
"""
from __future__ import annotations

import os
import time

import torch

from ..data.masking import get_mask_ratio
from ..models.mae import TinyViTMAE
from ..models.tiny_vit import tiny_vit_21m_variant
from ..train.finetune_engine import init_model
from ..train.mae_engine import make_token_mae_step, wrap_accum_and_skip
from ..train.state import TrainState, create_train_state, make_optimizer, warmup_cosine_schedule
from ..utils.checkpoint import (find_latest_checkpoint, keep_last_n_checkpoints,
                                restore_checkpoint, save_checkpoint)
from ..parallel import mesh as pmesh
from ..parallel.shard import (full_state_dict, load_full, local_state_dict,
                              optimizer_state_like)
from ..utils.config import config_hash, save_config
from ..utils.io import ensure_dir
from ..utils.metrics import format_metrics, update_best
from ..utils.prng import set_seed, step_generator
from . import common

DEFAULT_EMBED_DIMS = (96, 192, 384, 576)


def build_model(cfg: dict, dtype: torch.dtype,
                decoder_attn_impl: str | None = None) -> TinyViTMAE:
    """The pipeline-C model of ``cfg`` (TinyViT-21M at DEFAULT_EMBED_DIMS)
    with torch's default init (see ``init_model`` for the flax-like seeded
    init); ``decoder_attn_impl`` ``"sp"`` under a ``seq`` mesh."""
    mae = cfg["mae"]
    dec = mae.get("decoder", {})
    encoder = tiny_vit_21m_variant(use_checkpoint=bool(cfg.get("model", {}).get(
        "use_checkpoint", True)), dtype=dtype, embed_dims=DEFAULT_EMBED_DIMS)
    return TinyViTMAE(encoder, stage4_pool=int(mae.get("stage4_pool", 3)),
                      decoder_dim=int(dec.get("dim", 512)), decoder_depth=int(dec.get("depth", 2)),
                      decoder_num_heads=int(dec.get("num_heads", 8)),
                      mlp_ratio=float(dec.get("mlp_ratio", 4.0)), dtype=dtype,
                      attn_impl=decoder_attn_impl)


def _opt_like(state: TrainState, sd: dict) -> dict:
    """Which param's layout each of the optimizer state's tensors has."""
    return optimizer_state_like(state.model, state.params, sd)


def checkpoint_tensors(state: TrainState, mesh) -> dict:
    """The model's state and the optimizer's (under ``opt.``), whole: on a
    ``model`` mesh every rank takes part in the gathers."""
    opt = state.tx.state_dict()
    return {**full_state_dict(state.model, mesh),
            **{f"opt.{k}": v for k, v in
               full_state_dict(state.model, mesh, opt, _opt_like(state, opt)).items()}}


def _restore(latest: str, state: TrainState, cfg_hash: str, log) -> tuple[int, dict | None]:
    """Load ``latest`` (a whole checkpoint) into ``state`` in place, this
    rank's part of each cut tensor; returns (start epoch, best)."""
    blob = restore_checkpoint(latest)
    tensors = {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}
    load_full(state.model, {k: v for k, v in tensors.items() if not k.startswith("opt.")})
    if blob.get("has_opt_state"):
        # FULL resume (ref: src/mae/utils.py:73-92 checkpoints
        # model+optimizer+scheduler): the Adam moments, the count that the
        # warmup-cosine schedule reads and the skip/accumulation counters
        opt = {k[len("opt."):]: v for k, v in tensors.items() if k.startswith("opt.")}
        state.tx.load_state_dict(local_state_dict(state.model, opt, _opt_like(state, opt)))
    else:
        log("[WARN] legacy checkpoint without opt_state; optimizer "
            "moments and LR schedule restart from zero")
    if blob.get("cfg_hash") not in (None, cfg_hash):
        log(f"[WARN] resume cfg_hash mismatch ({blob.get('cfg_hash')} != {cfg_hash})")
    state.step = int(blob.get("step", 0))
    return int(blob["epoch"]) + 1, blob.get("best")


def run(cfg: dict, log=print, max_steps: int | None = None, resume: bool = True,
        device: str | torch.device | None = None, on_step=None) -> dict:
    """Train. ``device``: argument, else ``device.name``, else cuda (under
    a launcher, this rank's card: the batch over a ``data`` mesh, or the
    clips' frames over a ``seq`` mesh with ``model.sequence_parallel``;
    rank 0 alone writes). ``on_step(global_step, state, metrics)`` is
    called after every step."""
    device = common.init_distributed(cfg, device, log)
    par = common.setup_parallelism(cfg, int(cfg["training"]["batch_size"]), log)
    if not par.member:
        return {"best": None, "steps": 0, "completed": True}
    mesh = par.mesh
    main = pmesh.is_main()
    seed = int(cfg.get("seed", 42))
    init_gen = set_seed(seed)
    dtype = common.compute_dtype_from(cfg, device)

    ds = common.dataset_from_cfg(cfg, common.split_path(cfg, cfg["dataset"]["train_split"]),
                                 "ssl", seed=seed)
    tr = cfg["training"]
    mae = cfg["mae"]
    B = int(tr["batch_size"])
    P = int(mae.get("stage4_pool", 3)) ** 2
    steps_per_epoch = max(1, len(ds) // B)
    epochs = int(tr["epochs"])

    out_dir = cfg.get("output", {}).get("dir", "results/mae")
    if main:
        ensure_dir(out_dir)
        cfg_hash = save_config(cfg, os.path.join(out_dir, "config.json"))
    else:
        cfg_hash = config_hash(cfg)
    log(f"[INFO] train_mae: cfg_hash={cfg_hash} device={device} "
        f"dtype={str(dtype).replace('torch.', '')}")
    vis_ds = ds  # the pictures read the host's first clip
    ds = common.maybe_device_resident(cfg, ds, device, log)
    model = build_model(cfg, dtype, decoder_attn_impl="sp" if par.sp_on else None)
    init_model(model, init_gen)
    model.to(device)
    common.place_model(model, mesh, log)

    sched = warmup_cosine_schedule(
        float(tr.get("lr", 3e-4)), int(tr.get("warmup_epochs", 0)) * steps_per_epoch,
        epochs * steps_per_epoch, float(tr.get("min_lr", 0.0)))
    tx = make_optimizer(model.parameters(), sched,
                        weight_decay=float(tr.get("weight_decay", 0.05)),
                        grad_clip=float(tr.get("clip_grad_norm", 1.0)),
                        betas=tuple(tr.get("betas", (0.9, 0.95))))
    tx = wrap_accum_and_skip(tx, accum_steps=int(tr.get("grad_accum", 1)))
    state = create_train_state(model, tx)

    loss_cfg = mae.get("loss", {})
    mask_mode = str(mae.get("mask_mode", "tube"))
    step_fn = make_token_mae_step(
        model, tokens_per_frame=P, mask_mode=mask_mode,
        loss_type=str(loss_cfg.get("type", "l2")),
        normalize_target=bool(loss_cfg.get("normalize_target", True)),
        augment_hflip=bool(cfg.get("dataset", {}).get("augment", False)),
        compute_dtype=dtype, mesh=mesh)

    start_epoch, best = 1, None
    if resume:
        latest = find_latest_checkpoint(out_dir)
        if latest:
            start_epoch, best = _restore(latest, state, cfg_hash, log)
            log(f"[INFO] resumed from {latest} at epoch {start_epoch}")

    log_interval = int(tr.get("log_interval", 20))
    save_every = int(tr.get("save_every", 5))
    keep_last = int(tr.get("keep_last", 5))
    vis_every = int(mae.get("vis_every", 0))
    if vis_every and mesh is not None and (mesh.model_axis == "model" or par.sp_on):
        log(f"[WARN] mae.vis_every={vis_every}: the picture's forward would need every "
            "rank of this model or seq mesh; no pictures in this run")
        vis_every = 0
    # segment cap: exit cleanly (with a checkpoint) after N epochs, so a
    # wrapper can run the job as a chain of fresh processes
    max_epochs_per_run = tr.get("max_epochs_per_run")

    global_step = state.step
    for epoch in range(start_epoch, epochs + 1):
        ratio = get_mask_ratio(epoch, mae.get("mask_ratio_schedule"),
                               float(mae.get("mask_ratio", 0.8)))
        t_ep = time.perf_counter()
        data_t, iter_t = 0.0, 0.0
        t_last = time.perf_counter()
        metrics = None
        epoch_metrics: dict = {}
        for step, batch in enumerate(
                common.epoch_batches(ds, B, shuffle=True, seed=seed, epoch=epoch,
                                     device=device, mesh=mesh), 1):
            data_t += time.perf_counter() - t_last
            gen = step_generator(seed, global_step, device)
            state, metrics = step_fn(state, batch, gen, ratio)
            global_step += 1
            if on_step is not None:
                on_step(global_step, state, metrics)
            iter_t += time.perf_counter() - t_last
            t_last = time.perf_counter()
            if step % log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                log(f"[INFO] ep={epoch} step={step}/{steps_per_epoch} ratio={ratio:.2f} "
                    + format_metrics(m) + f" data_t={data_t:.1f}s iter_t={iter_t:.1f}s")
                if m["collapse"] > 0:
                    log("[WARN:pred_std_low] possible representation collapse")
            if max_steps is not None and global_step >= max_steps:
                break
        if metrics is not None:
            epoch_metrics = {k: float(v) for k, v in metrics.items()}
            best, _ = update_best(best, {"epoch": epoch, **epoch_metrics}, key="loss",
                                  mode="min")
        log(f"[INFO] epoch {epoch} done in {time.perf_counter() - t_ep:.1f}s "
            + format_metrics(epoch_metrics))

        hit_segment_cap = (max_epochs_per_run is not None
                           and epoch - start_epoch + 1 >= int(max_epochs_per_run)
                           and epoch < epochs)
        if epoch % save_every == 0 or epoch == epochs or hit_segment_cap:
            tensors = checkpoint_tensors(state, mesh)
            if main:
                save_checkpoint(out_dir, f"ckpt_epoch_{epoch}", tensors,
                                meta={"step": state.step, "epoch": epoch, "cfg_hash": cfg_hash,
                                      "best": best, "has_opt_state": True})
                deleted = keep_last_n_checkpoints(out_dir, keep_last)
                log(f"[INFO] saved ckpt_epoch_{epoch} (gc: {len(deleted)} old)")
            pmesh.barrier(mesh)  # the checkpoint is on disk for every rank
        if vis_every and epoch % vis_every == 0 and main:
            try:
                from ..reporting.visualize import save_mae_vis
                save_mae_vis(state.model, vis_ds, out_dir, epoch, P, ratio, mask_mode, dtype)
            except Exception as e:  # vis must never kill training
                log(f"[WARN] vis failed: {type(e).__name__}: {e}")
        if hit_segment_cap:
            log(f"[INFO] segment cap ({max_epochs_per_run} epochs/run) hit at "
                f"epoch {epoch}/{epochs}; exiting — relaunch to resume")
            return {"best": best, "steps": global_step, "completed": False,
                    "stopped_at_epoch": epoch}
        if max_steps is not None and global_step >= max_steps:
            break

    return {"best": best, "steps": global_step, "completed": True}


def main():
    p = common.make_parser("Feature-space token MAE (pipeline C)")
    p.add_argument("--cfg", type=str, default=None, help="alias for --config")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    if args.cfg and not args.config:
        args.config = args.cfg
    cfg = common.load_merged_config(args, "configs/mae_train.yaml")
    logger = common.make_logger(cfg, "train_mae")
    with pmesh.process_group_scope():
        run(cfg, log=logger.log, resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
