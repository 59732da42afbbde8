"""SSL pipeline B CLI: pixel-reconstruction VideoMAE pretraining
(counterpart of the JAX package's ``entry/train_ssl_mae.py``; reference:
src/train_ssl_mae.py).

TinyViT stage-3 features + tube mask (default 0.9) + norm-pix masked MSE,
AdamW with warmup-cosine schedule, gradient accumulation and non-finite
skip, bf16 compute on the card, throughput (clips/s, and MFU against the
H100's bf16 peak on a card) + ETA logging, encoder-only checkpoints every
``save_every`` epochs (full ones with ``training.save_full``). The opt-in
MoE decoder (``model.decoder_moe_*``, its load-balance auxiliary weighted by
``ssl.moe_aux_weight``, default 0.01) and the 64-frame long clip
(``configs/ssl_mae_longclip.yaml``) run as configured;
``logging.profile_dir`` traces the first 8 steps with ``torch.profiler``,
the port's spans on (``utils/tracing.py``) so that its trace carries them;
``logging.tensorboard`` writes ``Train/Loss``, ``Train/Throughput`` and
``Train/MFU`` at every logged step through ``tensorboardX`` on rank 0
(under ``training.save_dir``; a warning where it is missing).
The split is device-resident as ``dataset.device_resident`` says. Under
``torchrun`` one process a card: the multi-device knobs are resolved as
the JAX entry resolves them over its devices (``common.setup_parallelism``):
the batch over a ``data`` mesh; with ``model.sequence_parallel`` each clip's
frames over a ``seq`` mesh (the long clip's decoder attends through
``parallel/sp.py``); with ``device.expert_parallel`` the MoE decoder's
experts over a ``data`` x ``expert`` mesh (``configs/ssl_mae_moe.yaml`` as
shipped); with ``device.model_parallel`` attention heads and MLP units over
a ``data`` x ``model`` mesh; with ``device.pipeline_parallel`` the
decoder's blocks over a ``pipe`` mesh in ``device.pp_microbatches``
microbatches. Rank 0 alone writes logs, and the checkpoints are gathered
whole: the files one device writes.

    python -m ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae \\
        --config configs/ssl_mae.yaml --device cuda
    torchrun --standalone --nproc_per_node 8 \\
        -m ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae --config configs/ssl_mae.yaml
    torchrun --standalone --nproc_per_node 4 \\
        -m ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae --config configs/ssl_mae_moe.yaml
    torchrun --standalone --nproc_per_node 4 \\
        -m ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae --config configs/ssl_mae.yaml \\
        --set device.pipeline_parallel=4       # or --set device.model_parallel=4
"""
from __future__ import annotations

import os
import time

import torch

from ..models.mae import TinyVideoMAE
from ..models.tiny_vit import tiny_vit_21m_variant
from ..parallel import mesh as pmesh
from ..parallel.shard import full_state_dict
from ..train.finetune_engine import init_model
from ..train.mae_engine import make_pixel_mae_step, wrap_accum_and_skip
from ..train.state import create_train_state, make_optimizer, warmup_cosine_schedule
from ..utils import tracing
from ..utils.checkpoint import save_checkpoint
from ..utils.io import ensure_dir
from ..utils.metrics import pipeline_b_mfu, pipeline_b_model_kwargs
from ..utils.prng import set_seed
from . import common


def build_model(cfg: dict, dtype: torch.dtype, attn_impl: str | None = None,
                decoder_attn_impl: str | None = None) -> TinyVideoMAE:
    """The pipeline-B model of ``cfg`` with torch's default init (see
    ``init_model`` for the flax-like seeded init); ``decoder_attn_impl``
    (``"sp"`` under a ``seq`` mesh) overrides ``attn_impl`` in the
    decoder."""
    m = cfg["model"]
    remat_stages = m.get("remat_stages")
    encoder = tiny_vit_21m_variant(
        use_checkpoint=bool(m.get("use_checkpoint", True)), dtype=dtype,
        attn_impl=attn_impl,
        embed_dims=tuple(m.get("embed_dims", (96, 192, 384, 576))),
        remat_stages=tuple(remat_stages) if remat_stages is not None else None,
        num_stages=3,
    )
    return TinyVideoMAE(
        encoder,
        clip_len=int(cfg["dataset"]["clip_len"]),
        img_size=int(cfg["dataset"]["image_size"]),
        patch_size=8,
        decoder_embed_dim=int(m["decoder_embed_dim"]),
        decoder_depth=int(m["decoder_depth"]),
        decoder_num_heads=int(m["decoder_num_heads"]),
        dtype=dtype,
        attn_impl=decoder_attn_impl or attn_impl,
        decoder_moe_experts=int(m.get("decoder_moe_experts", 0) or 0),
        decoder_moe_capacity_factor=float(m.get("decoder_moe_capacity_factor", 2.0)),
        decoder_moe_group_size=int(m.get("decoder_moe_group_size", 0) or 0),
    )


PROFILE_STEPS = 8  # logging.profile_dir traces the first steps, as the JAX entry


def start_profiler(device: torch.device):
    """A started ``torch.profiler`` over the host and, on a card, the device,
    with the port's spans on: each is a ``ssl_vit.<name>`` range of its
    trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=acts)
    profiler.start()
    tracing.enable()
    return profiler


def _host(x: torch.Tensor) -> float:
    return float(tracing.host_read(x))


def stop_profiler(profiler, profile_dir: str, log=print) -> str:
    """Turn the spans off, stop ``profiler`` and write its chrome trace under
    ``profile_dir``."""
    tracing.disable()
    profiler.stop()
    ensure_dir(profile_dir)
    path = os.path.join(profile_dir, "train_ssl_mae_trace.json")
    profiler.export_chrome_trace(path)
    log("[INFO] profiler trace written")
    return path


def run(cfg: dict, log=print, max_steps: int | None = None,
        device: str | torch.device | None = None, on_step=None) -> dict:
    """Train. ``device``: argument, else ``device.name``, else cuda (under
    a launcher, this rank's card). ``on_step(global_step, state, metrics)``
    is called after every step."""
    device = common.init_distributed(cfg, device, log)
    par = common.setup_parallelism(cfg, int(cfg["training"]["batch_size"]), log,
                                   allow_pp=True)
    if not par.member:
        return {"steps": 0, "seconds": 0.0, "last_loss": float("nan")}
    mesh = par.mesh
    cards = 1 if mesh is None else mesh.size()
    seed = int(cfg.get("seed", 42))
    init_gen = set_seed(seed)
    dtype = common.compute_dtype_from(cfg, device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"[INFO] ssl_mae: device={device} ({name}) dtype={str(dtype).replace('torch.', '')}")
    tb = None
    if cfg.get("logging", {}).get("tensorboard", False) and pmesh.is_main():
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(cfg["training"].get("save_dir", "results/tinymae_v1"))
        except ImportError:
            log("[WARN] tensorboardX unavailable; skipping TB logging")
    profile_dir = cfg.get("logging", {}).get("profile_dir")

    ds = common.dataset_from_cfg(cfg, common.split_path(cfg, cfg["dataset"]["train_split"]),
                                 "ssl", seed=seed)
    tr = cfg["training"]
    B = int(tr["batch_size"])
    T = ds.clip_len
    S = ds.image_size
    steps_per_epoch = max(1, len(ds) // B)
    epochs = int(tr["epochs"])
    ds = common.maybe_device_resident(cfg, ds, device, log)

    model = build_model(cfg, dtype, decoder_attn_impl="sp" if par.sp_on else None)
    depth = len(model.decoder.blocks)
    if par.pp_mesh is not None and depth % par.pp_mesh.size("pipe"):
        raise ValueError(f"decoder_depth={depth} not divisible by "
                         f"pipeline_parallel={par.pp_mesh.size('pipe')}")
    init_model(model, init_gen)
    model.to(device)
    L = (S // 8) ** 2
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[INFO] model params: {n_params / 1e6:.2f}M, tokens/frame={L}")
    common.place_model(model, mesh, log)

    sched = warmup_cosine_schedule(
        float(tr.get("lr", 5e-4)),
        int(tr.get("warmup_epochs", 0)) * steps_per_epoch,
        epochs * steps_per_epoch,
        float(tr.get("min_lr", 0.0)),
    )
    # pipeline B never clips unless the config asks (a 1.0 clip froze it,
    # see the JAX entry)
    tx = make_optimizer(model.parameters(), sched,
                        weight_decay=float(tr.get("weight_decay", 0.05)),
                        grad_clip=(float(tr["clip_grad_norm"])
                                   if tr.get("clip_grad_norm") is not None else None))
    tx = wrap_accum_and_skip(tx, accum_steps=int(tr.get("accumulation_steps", 1)))
    state = create_train_state(model, tx)
    ssl = cfg.get("ssl", {})
    step_fn = make_pixel_mae_step(model, mask_ratio=float(ssl.get("mask_ratio", 0.9)),
                                  patch_size=8,
                                  norm_pix_loss=bool(ssl.get("norm_pix_loss", True)),
                                  compute_dtype=dtype,
                                  # the Switch-Transformer default; no-op for
                                  # the dense decoder
                                  moe_aux_weight=float(ssl.get("moe_aux_weight", 0.01)),
                                  mesh=None if par.pp_mesh is not None else mesh,
                                  pp_mesh=par.pp_mesh, pp_microbatches=par.pp_microbatches)
    step_gen = torch.Generator(device=device).manual_seed(seed + 1)

    save_dir = tr.get("save_dir", "results/tinymae_v1")
    main = pmesh.is_main()
    if main:
        ensure_dir(save_dir)
    log_interval = int(tr.get("log_interval", 20))
    save_every = int(tr.get("save_every", 10))
    mfu_kwargs = pipeline_b_model_kwargs(cfg)

    global_step = 0
    t_start = time.perf_counter()
    last_loss = float("nan")
    profiler = None
    if profile_dir and main:
        profiler = start_profiler(device)
        log(f"[INFO] profiling first steps to {profile_dir}")
    for epoch in range(1, epochs + 1):
        t_ep = time.perf_counter()
        seen = 0
        metrics = None
        # device scalars, fetched once per epoch (the per-step loss is
        # tube-mask noise; the epoch mean is the summary)
        epoch_losses = []
        for step, batch in enumerate(
                common.epoch_batches(ds, B, shuffle=True, seed=seed, epoch=epoch,
                                     device=device, mesh=mesh), 1):
            state, metrics = step_fn(state, batch, step_gen)
            epoch_losses.append(metrics["loss"])
            global_step += 1
            seen += B
            if profiler is not None and global_step >= PROFILE_STEPS:
                stop_profiler(profiler, profile_dir, log)
                profiler = None
            if on_step is not None:
                on_step(global_step, state, metrics)
            if step % log_interval == 0:
                last_loss = _host(metrics["loss"])  # waits for the device
                dt = time.perf_counter() - t_ep
                ips = seen / max(dt, 1e-9)
                eta = (steps_per_epoch - step) * (dt / step)
                mfu = (pipeline_b_mfu(ips, T, S, cards=cards, **mfu_kwargs)
                       if device.type == "cuda" else 0.0)
                moe = (f" moe_aux={_host(metrics['moe_aux']):.3f}"
                       if "moe_aux" in metrics else "")
                log(f"[INFO] ep={epoch} step={step}/{steps_per_epoch} "
                    f"loss={last_loss:.4f} pred_std={_host(metrics['pred_std']):.4f} "
                    f"gnorm={_host(metrics['grad_norm']):.2e} "
                    f"clips/s={ips:.1f} mfu={mfu:.3f} eta={eta:.0f}s{moe}")
                if tb is not None:
                    tb.add_scalar("Train/Loss", last_loss, global_step)
                    tb.add_scalar("Train/Throughput", ips, global_step)
                    tb.add_scalar("Train/MFU", mfu, global_step)
                if _host(metrics["collapse"]) > 0:
                    log("[WARN:pred_std_low] possible representation collapse")
            if max_steps is not None and global_step >= max_steps:
                break
        if metrics is not None:
            last_loss = _host(metrics["loss"])
        loss_mean = (_host(torch.stack(epoch_losses).mean())
                     if epoch_losses else float("nan"))
        log(f"[INFO] epoch {epoch} done in {time.perf_counter() - t_ep:.1f}s "
            f"loss={last_loss:.4f} loss_mean={loss_mean:.4f}")
        if epoch % save_every == 0 or epoch == epochs:
            # gathered whole over a model axis (every rank takes part)
            sd = full_state_dict(model, mesh)
            if main:
                # encoder-only checkpoint, like the reference
                path = save_checkpoint(save_dir, f"ckpt_epoch_{epoch}",
                                       {k: v for k, v in sd.items() if k.startswith("encoder.")})
                log(f"[INFO] saved encoder checkpoint: {path}")
                if bool(tr.get("save_full", False)):
                    path = save_checkpoint(save_dir, f"ckpt_full_epoch_{epoch}", sd)
                    log(f"[INFO] saved full checkpoint: {path}")
            pmesh.barrier(mesh)  # the checkpoint is on disk for every rank
        if max_steps is not None and global_step >= max_steps:
            break

    if profiler is not None:
        stop_profiler(profiler, profile_dir, log)
    if tb is not None:
        tb.close()
    total = time.perf_counter() - t_start
    return {"steps": global_step, "seconds": total, "last_loss": last_loss}


def main():
    p = common.make_parser("VideoMAE SSL pretraining (pipeline B)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/ssl_mae.yaml")
    logger = common.make_logger(cfg, "train_ssl_mae")
    with pmesh.process_group_scope():
        run(cfg, log=logger.log, device=args.device)


if __name__ == "__main__":
    main()
