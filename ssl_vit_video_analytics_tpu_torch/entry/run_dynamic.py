"""Dynamic-inference benchmark CLI (counterpart of the JAX package's
``entry/run_dynamic.py``).

Three modes over the val split, each writing a CSV with the reference's
exact headers and float formats:

- early_exit:   threshold sweep, confidence-based early exit
- frame_gating: top-k motion/random frame selection + full forward
- hybrid:       gating(k) then early-exit(threshold), k x thr grid

Latency is host wall time around one batch's call, ended by a host copy of
its result (which waits for the device), with the same warmup/measure batch
windows as the JAX entry.

    python -m ssl_vit_video_analytics_tpu_torch.entry.run_dynamic \\
        --config configs/dynamic.yaml --device cuda
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.dynamic import early_exit_batched, select_topk_frames, streaming_early_exit
from ..ops.preprocess import normalize_clip
from ..train import finetune_engine as eng
from ..utils import tracing
from ..utils.checkpoint import checkpoint_path, read_checkpoint
from ..utils.io import ensure_dir, write_csv
from ..utils.prng import set_seed
from . import common

# CSV headers, byte-compatible with the reference outputs
EARLY_EXIT_FIELDS = ("threshold", "top1", "top5", "avg_frames", "avg_conf",
                     "avg_latency_ms", "throughput_fps")
FRAME_GATING_FIELDS = ("k", "top1", "top5", "avg_latency_ms", "throughput_clips_per_s")
HYBRID_FIELDS = ("k", "threshold", "top1", "top5", "avg_used_frames", "avg_conf",
                 "avg_latency_ms")


def load_classifier(cfg: dict, dtype: torch.dtype, device: torch.device,
                    log) -> torch.nn.Module:
    """The classifier of ``cfg`` in eval mode on ``device``: seeded init,
    then ``model.finetune_ckpt`` if it exists (else a warning)."""
    model = eng.build_model(int(cfg["dataset"]["num_classes"]),
                            int(cfg["model"]["embed_dim"]), dtype=dtype,
                            backbone=str(cfg["model"].get("backbone", "mobilevit_s")),
                            backbone_kwargs=cfg["model"].get("backbone_kwargs"))
    # fixed seed 0 for the random init, as the JAX entry's jax.random.key(0)
    eng.init_model(model, torch.Generator().manual_seed(0))
    ckpt = cfg["model"].get("finetune_ckpt")
    if ckpt and checkpoint_path(ckpt):
        model.load_state_dict(read_checkpoint(ckpt))
        log(f"[INFO] loaded finetune ckpt: {ckpt}")
    else:
        log(f"[WARN] finetune ckpt not found ({ckpt}); random weights")
    return model.to(device).eval()


def _topk_np(logits: np.ndarray, labels: np.ndarray, ks=(1, 5)):
    order = np.argsort(-logits, axis=1)
    out = {}
    for k in ks:
        out[k] = float(np.mean([labels[i] in order[i, :k] for i in range(len(labels))]))
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return tracing.host_read(t).numpy()


def _valid_rows(arr: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Keep only real (non-padding) samples of a padded tail batch."""
    return arr[np.asarray(valid)]


def _measure_window(rt: dict, ds, batch_size: int) -> tuple[int, int]:
    """Warmup/measure batch window, clamped to the actual batch count:
    >= 1 warmup batch and >= 1 measured batch whenever two batches exist."""
    n_batches = -(-len(ds) // batch_size)
    warm = int(rt.get("num_warmup", 10))
    meas = int(rt.get("num_measure", 50))
    # every mode also pre-warms on the first batch before its timed loop,
    # so warm=0 (single-batch val split) still measures honestly
    warm = max(1, min(warm, n_batches - 1)) if n_batches > 1 else 0
    return warm, max(1, meas)


def _batches(ds, B, device):
    return common.epoch_batches(ds, B, shuffle=False, seed=0, epoch=0,
                                device=device, drop_last=False)


def _early_exit_fn(cfg, log):
    """dynamic.early_exit_impl: streaming | batched | auto (default).

    Both give identical statistics. ``auto`` keeps the JAX entry's rule,
    batched only on a TPU, so it is streaming here: per-frame encodes can
    stop as soon as every sample has exited.
    """
    impl = str(cfg.get("dynamic", {}).get("early_exit_impl", "auto")).lower()
    if impl == "auto":
        impl = "streaming"
    if impl not in ("streaming", "batched"):
        raise ValueError(f"[ERROR] Unknown early_exit_impl: {impl}")
    log(f"[INFO] early-exit impl: {impl}")
    return early_exit_batched if impl == "batched" else streaming_early_exit


def _ee_kwargs(dyn: dict) -> dict:
    return dict(min_frames=int(dyn.get("min_frames", 4)),
                max_frames=dyn.get("max_frames"),
                frame_step=int(dyn.get("frame_step", 1)))


def run_early_exit(cfg, model, ds, device, log) -> list[dict]:
    dyn = cfg["dynamic"]
    rt = cfg["runtime"]
    B = int(rt["batch_size"])
    warm, meas = _measure_window(rt, ds, B)
    ee_fn = _early_exit_fn(cfg, log)

    def fn_full(raw, thr):
        return ee_fn(model.frame_embedding, model.classify_embedding,
                     normalize_clip(raw), thr, **_ee_kwargs(dyn))

    wb = common.first_batch(ds, B, device)
    _np(fn_full(wb["clip"], float(dyn["confidence_thresholds"][0]))[1].final_conf)
    rows = []
    for thr in dyn["confidence_thresholds"]:
        logits_all, labels_all, used_all, conf_all = [], [], [], []
        times = []
        # drop_last=False + valid mask: the full val split contributes
        for i, batch in enumerate(_batches(ds, B, device)):
            t0 = time.perf_counter()
            logits, stats = fn_full(batch["clip"], float(thr))
            conf = _np(stats.final_conf)  # host copy: waits for the device
            dt = (time.perf_counter() - t0) * 1000.0
            if warm <= i < warm + meas:
                times.append(dt)
            v = _np(batch["valid"])
            logits_all.append(_valid_rows(_np(logits), v))
            labels_all.append(_valid_rows(_np(batch["label"]), v))
            used_all.append(_valid_rows(_np(stats.used_frames), v))
            conf_all.append(_valid_rows(conf, v))
        accs = _topk_np(np.concatenate(logits_all), np.concatenate(labels_all))
        avg_frames = float(np.mean(np.concatenate(used_all)))
        avg_latency = float(np.mean(times)) if times else 0.0
        # effective frames/sec processed
        clips_per_sec = (B / (avg_latency / 1000.0)) if avg_latency > 0 else 0.0
        throughput_fps = clips_per_sec * avg_frames
        row = {
            "threshold": f"{float(thr):.2f}",
            "top1": f"{accs[1]:.6f}",
            "top5": f"{accs[5]:.6f}",
            "avg_frames": f"{avg_frames:.3f}",
            "avg_conf": f"{float(np.mean(np.concatenate(conf_all))):.4f}",
            "avg_latency_ms": f"{avg_latency:.3f}",
            "throughput_fps": f"{throughput_fps:.2f}",
        }
        rows.append(row)
        log(f"[INFO] early_exit thr={thr} top1={row['top1']} frames={row['avg_frames']} "
            f"lat={row['avg_latency_ms']}ms")
    return rows


def run_frame_gating(cfg, model, ds, device, log) -> list[dict]:
    dyn = cfg["dynamic"]
    rt = cfg["runtime"]
    B = int(rt["batch_size"])
    warm, meas = _measure_window(rt, ds, B)
    score = str(dyn.get("gating_score", "motion"))

    rows = []
    wb = common.first_batch(ds, B, device)  # fetched once; reused for every k's warm call
    for k in dyn["gating_topk_list"]:
        k_eff = min(int(k), ds.clip_len)

        def fn(raw, gen, k=k_eff):
            sel, _ = select_topk_frames(normalize_clip(raw), k, score_type=score,
                                        generator=gen)
            return model(sel)

        _np(fn(wb["clip"], torch.Generator().manual_seed(1)))  # warm
        logits_all, labels_all, times = [], [], []
        gen = torch.Generator().manual_seed(0)
        for i, batch in enumerate(_batches(ds, B, device)):
            t0 = time.perf_counter()
            logits = _np(fn(batch["clip"], gen))  # host copy: waits for the device
            dt = (time.perf_counter() - t0) * 1000.0
            if warm <= i < warm + meas:
                times.append(dt)
            v = _np(batch["valid"])
            logits_all.append(_valid_rows(logits, v))
            labels_all.append(_valid_rows(_np(batch["label"]), v))
        accs = _topk_np(np.concatenate(logits_all), np.concatenate(labels_all))
        avg_latency = float(np.mean(times)) if times else 0.0
        clips_per_sec = (B / (avg_latency / 1000.0)) if avg_latency > 0 else 0.0
        row = {
            "k": str(k_eff),
            "top1": f"{accs[1]:.6f}",
            "top5": f"{accs[5]:.6f}",
            "avg_latency_ms": f"{avg_latency:.3f}",
            "throughput_clips_per_s": f"{clips_per_sec:.2f}",
        }
        rows.append(row)
        log(f"[INFO] frame_gating k={k_eff} score={score} top1={row['top1']} "
            f"lat={row['avg_latency_ms']}ms")
    return rows


def run_hybrid(cfg, model, ds, device, log) -> list[dict]:
    dyn = cfg["dynamic"]
    rt = cfg["runtime"]
    B = int(rt["batch_size"])
    warm, meas = _measure_window(rt, ds, B)
    score = str(dyn.get("gating_score", "motion"))
    ee_fn = _early_exit_fn(cfg, log)

    rows = []
    wb = common.first_batch(ds, B, device)  # fetched once; reused for every k's warm call
    for k in dyn["gating_topk_list"]:
        k_eff = min(int(k), ds.clip_len)

        def fn(raw, gen, thr, k=k_eff):
            sel, _ = select_topk_frames(normalize_clip(raw), k, score_type=score,
                                        generator=gen)
            return ee_fn(model.frame_embedding, model.classify_embedding, sel, thr,
                         **_ee_kwargs(dyn))

        _np(fn(wb["clip"], torch.Generator().manual_seed(1),
               float(dyn["confidence_thresholds"][0]))[1].final_conf)  # warm
        for thr in dyn["confidence_thresholds"]:
            logits_all, labels_all, used_all, conf_all, times = [], [], [], [], []
            gen = torch.Generator().manual_seed(0)
            for i, batch in enumerate(_batches(ds, B, device)):
                t0 = time.perf_counter()
                logits, stats = fn(batch["clip"], gen, float(thr))
                used = _np(stats.used_frames)  # host copy: waits for the device
                dt = (time.perf_counter() - t0) * 1000.0
                if warm <= i < warm + meas:
                    times.append(dt)
                v = _np(batch["valid"])
                logits_all.append(_valid_rows(_np(logits), v))
                labels_all.append(_valid_rows(_np(batch["label"]), v))
                used_all.append(_valid_rows(used, v))
                conf_all.append(_valid_rows(_np(stats.final_conf), v))
            accs = _topk_np(np.concatenate(logits_all), np.concatenate(labels_all))
            row = {
                "k": str(k_eff),
                "threshold": f"{float(thr):.2f}",
                "top1": f"{accs[1]:.6f}",
                "top5": f"{accs[5]:.6f}",
                "avg_used_frames": f"{float(np.mean(np.concatenate(used_all))):.3f}",
                "avg_conf": f"{float(np.mean(np.concatenate(conf_all))):.4f}",
                "avg_latency_ms": f"{float(np.mean(times)) if times else 0.0:.3f}",
            }
            rows.append(row)
            log(f"[INFO] hybrid k={k_eff} thr={thr} top1={row['top1']} "
                f"frames={row['avg_used_frames']} lat={row['avg_latency_ms']}ms")
    return rows


def run(cfg: dict, mode: str | None = None, log=print,
        device: str | torch.device | None = None) -> dict:
    """Run one mode. ``device``: argument, else ``device.name``, else cuda."""
    device = common.device_from(cfg, device)
    set_seed(int(cfg.get("seed", 42)))
    dtype = common.compute_dtype_from(cfg, device)
    mode = mode or cfg.get("dynamic", {}).get("mode", "early_exit")
    runners = {"early_exit": run_early_exit, "frame_gating": run_frame_gating,
               "hybrid": run_hybrid}
    if mode not in runners:
        raise ValueError(f"[ERROR] Unknown dynamic mode: {mode}")
    ds = common.dataset_from_cfg(cfg, common.split_path(cfg, cfg["dataset"]["split"]),
                                 "supervised")
    model = load_classifier(cfg, dtype, device, log)
    # serving sweeps re-iterate the split once per knob setting; a resident
    # split makes each pass on-device gathers (dataset.device_resident)
    ds = common.maybe_device_resident(cfg, ds, device, log)

    save_dir = cfg.get("output", {}).get("save_dir", "results/dynamic")
    ensure_dir(save_dir)
    with torch.inference_mode():
        rows = runners[mode](cfg, model, ds, device, log)
    out_csv = os.path.join(save_dir, f"{mode}_results.csv")
    if cfg.get("output", {}).get("save_csv", True):
        write_csv(out_csv, rows)
        log(f"[INFO] wrote {out_csv}")
    return {"rows": rows, "csv": out_csv}


def main():
    p = common.make_parser("Dynamic inference latency-accuracy frontier")
    p.add_argument("--mode", type=str, default=None,
                   help="early_exit | frame_gating | hybrid")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/dynamic.yaml")
    logger = common.make_logger(cfg, f"dynamic_{args.mode or 'cfg'}")
    run(cfg, mode=args.mode, log=logger.log, device=args.device)


if __name__ == "__main__":
    main()
