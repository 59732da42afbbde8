"""Privacy evaluation CLI (counterpart of the JAX package's
``entry/run_privacy.py``; reference: src/run_privacy.py).

(a) Visual: face detection -> blur -> re-detection leakage stats over a
    sampled frame tree + before/after example grid. Detection is host-side
    OpenCV (YuNet from ``visual_privacy.yunet_model`` where cv2 has
    ``FaceDetectorYN``, else a stub); the blur runs on the device.
(b) Feature: noise sigma x mask-ratio grid on clean video embeddings (the
    MobileViT-S classifier's, on the device-resident split); utility
    top-1/5 + entropy, plus a re-identification attacker MLP whose top-1
    yields the privacy exposure rate.

Attacker protocol note: the attacker MLP is trained AND evaluated on the
same perturbed-embedding set, exactly like the reference
(ref: src/run_privacy.py:309-326), so attacker_top1 is an upper bound
(memorization-inclusive) on re-identification leakage, not a held-out
generalization estimate. CSV headers and round(x, 6) formats match the
reference (ref: src/run_privacy.py:204-219, :329-347).

    python -m ssl_vit_video_analytics_tpu_torch.entry.run_privacy \\
        --config configs/privacy.yaml --device cuda
"""
from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from ..ops.preprocess import normalize_clip
from ..privacy import (
    VisualAnonymizer, make_detector, perturb_features, train_attacker,
    prediction_entropy, privacy_exposure_rate, top1_accuracy,
)
from ..train import finetune_engine as eng
from ..utils.checkpoint import checkpoint_path, read_checkpoint
from ..utils.io import write_csv, ensure_dir
from ..utils.prng import set_seed
from . import common

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# CSV headers, byte-compatible with the reference outputs
# (ref: src/run_privacy.py:204-219, :345-347)
VISUAL_FIELDS = ("frame_root", "total_frames", "frames_with_face_before",
                 "frames_with_face_after", "avg_faces_before", "avg_faces_after",
                 "face_frame_rate_before", "face_frame_rate_after",
                 "flr_conditional", "per_relative", "seconds", "overwrite_saved_root")
FEATURE_FIELDS = ("sigma", "mask_ratio", "top1", "top5", "entropy",
                  "attacker_top1", "per_vs_clean")


def scan_images(frame_root: str, max_images: int, seed: int) -> list[str]:
    """Recursively gather image paths, seeded subsample
    (ref: src/run_privacy.py:74-90)."""
    exts = (".jpg", ".jpeg", ".png")
    paths = []
    for dirpath, _, files in os.walk(frame_root):
        for f in files:
            if f.lower().endswith(exts):
                paths.append(os.path.join(dirpath, f))
    paths.sort()
    rng = random.Random(seed)
    if len(paths) > max_images:
        paths = rng.sample(paths, max_images)
    return paths


def save_visual_examples(pairs, out_path: str, cols: int = 4) -> None:
    """before|after example grid jpg (ref: src/run_privacy.py:93-115)."""
    if cv2 is None or not pairs:
        return
    tiles = []
    for before, after in pairs:
        h = min(before.shape[0], 224)
        w = int(before.shape[1] * h / before.shape[0])
        b = cv2.resize(before, (w, h))
        a = cv2.resize(after, (w, h))
        tiles.append(np.concatenate([b, a], axis=1))
    rows = []
    for i in range(0, len(tiles), cols):
        chunk = tiles[i:i + cols]
        wmax = max(t.shape[1] for t in chunk)
        chunk = [np.pad(t, ((0, 0), (0, wmax - t.shape[1]), (0, 0))) for t in chunk]
        rows.append(np.concatenate(chunk, axis=1))
    wmax = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, wmax - r.shape[1]), (0, 0))) for r in rows]
    cv2.imwrite(out_path, np.concatenate(rows, axis=0))


def run_visual_privacy(cfg: dict, save_dir: str, device: torch.device, log=print) -> str:
    vp = cfg.get("visual_privacy", {})
    out_csv = os.path.join(save_dir, "visual_privacy.csv")
    if not vp.get("enabled", True):
        log("[INFO] visual_privacy disabled -> skip")
        return out_csv

    frame_root = vp.get("frame_root", "data/FaceForensics_frames")
    images = scan_images(frame_root, int(vp.get("max_images", 2000)),
                         int(cfg.get("seed", 42)))
    log(f"[INFO] Visual privacy: {len(images)} sampled frames from {frame_root}")
    if not images:
        raise RuntimeError("[ERROR] No valid frames read in visual privacy eval.")

    detector = make_detector(vp.get("yunet_model"), float(vp.get("conf_threshold", 0.6)),
                             float(vp.get("nms_threshold", 0.3)))
    log(f"[INFO] detector: {type(detector).__name__}")
    anonymizer = VisualAnonymizer(detector, method=vp.get("method", "face_blur"),
                                  blur_kernel=int(vp.get("blur_kernel", 31)), device=device)

    total = fb = fa = faces_b = faces_a = 0
    example_pairs = []
    n_examples = int(vp.get("save_examples", 8))
    t0 = time.time()
    for p in images:
        img = cv2.imread(p) if cv2 is not None else None
        if img is None:
            continue
        total += 1
        before = detector.detect(img)
        n_before = len(before)
        fb += int(n_before > 0)
        faces_b += n_before
        anon, _ = anonymizer.apply(img)
        after = detector.detect(anon)
        n_after = len(after)
        fa += int(n_after > 0)
        faces_a += n_after
        if len(example_pairs) < n_examples and n_before > 0:
            example_pairs.append((img, anon))
    dt = time.time() - t0
    if total == 0:
        raise RuntimeError("[ERROR] No valid frames read in visual privacy eval.")

    before_rate = fb / max(1, total)
    after_rate = fa / max(1, total)
    rows = [{
        "frame_root": str(frame_root),
        "total_frames": int(total),
        "frames_with_face_before": int(fb),
        "frames_with_face_after": int(fa),
        "avg_faces_before": round(faces_b / max(1, total), 6),
        "avg_faces_after": round(faces_a / max(1, total), 6),
        "face_frame_rate_before": round(before_rate, 6),
        "face_frame_rate_after": round(after_rate, 6),
        "flr_conditional": round(fa / max(1, fb), 6),
        "per_relative": round(privacy_exposure_rate(before_rate, after_rate), 6),
        "seconds": round(dt, 3),
        "overwrite_saved_root": "",
    }]
    write_csv(out_csv, rows)
    log(f"[INFO] Saved visual privacy CSV: {out_csv}")
    if example_pairs:
        save_visual_examples(example_pairs, os.path.join(save_dir, "visual_privacy_examples.jpg"))
    return out_csv


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_feature_privacy(cfg: dict, save_dir: str, device: torch.device, log=print) -> str:
    fp = cfg.get("feature_privacy", {})
    out_csv = os.path.join(save_dir, "feature_privacy.csv")
    if not fp.get("enabled", True):
        log("[INFO] feature_privacy disabled -> skip")
        return out_csv

    dtype = common.compute_dtype_from(cfg, device)
    ds = common.dataset_from_cfg(cfg, common.split_path(cfg, cfg["dataset"]["split"]),
                                 "supervised")
    B = int(cfg["runtime"]["batch_size"])
    ds = common.maybe_device_resident(cfg, ds, device, log, batch_size=B)
    num_classes = int(cfg["dataset"]["num_classes"])
    model = eng.build_model(num_classes, int(cfg["model"]["embed_dim"]), dtype=dtype,
                            backbone=str(cfg["model"].get("backbone", "mobilevit_s")))
    # fixed seed 0 for the random init, as the JAX entry's jax.random.key(0)
    eng.init_model(model, torch.Generator().manual_seed(0))
    ckpt = cfg["model"].get("finetune_ckpt")
    if ckpt and checkpoint_path(ckpt):
        model.load_state_dict(read_checkpoint(ckpt))
        log(f"[INFO] loaded finetune ckpt: {ckpt}")
    else:
        log(f"[WARN] finetune ckpt not found ({ckpt}); random weights")
    model.to(device).eval()

    # 1. clean embeddings + logits
    zs, ys, batch_ms = [], [], []
    with torch.no_grad():
        for batch in common.epoch_batches(ds, B, shuffle=False, seed=0, epoch=0,
                                          device=device, drop_last=False):
            t0 = time.perf_counter()
            z = model.video_embedding(normalize_clip(batch["clip"], dtype=dtype)).float()
            valid = batch["valid"].to(device).bool()
            zs.append(z[valid])
            ys.append(batch["label"].to(device)[valid])
            _sync(device)
            batch_ms.append(1e3 * (time.perf_counter() - t0))
        zs_all = torch.cat(zs)
        ys_all = torch.cat(ys).long()
        logits_clean = model.classify_embedding(zs_all)
    log(f"[INFO] embedded {len(zs_all)} clips in {len(batch_ms)} batches of {B}: "
        f"{sum(batch_ms):.3f} ms, the first batch {batch_ms[0]:.3f} ms")
    clean_top1 = top1_accuracy(logits_clean, ys_all)
    clean_ent = prediction_entropy(logits_clean)
    log(f"[INFO] Clean embeddings -> Top-1={clean_top1:.4f}, Entropy={clean_ent:.4f}")
    # Embedding scale anchor for choosing sigma: sigma is ABSOLUTE (reference
    # units, ref: src/privacy/feature_noise.py:4-15), so whether a given
    # sigma does anything depends on this scale. The population std, as
    # jnp.std (torch.std defaults to the unbiased one).
    per_dim_std = float(zs_all.std(dim=0, correction=0).mean())
    log(f"[INFO] embedding per-dim std (mean over dims) = {per_dim_std:.4f}; "
        f"sigma=1.0 std-units is sigma={per_dim_std:.4f} absolute")

    generator = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 42)))
    # attacker_repeats > 1 draws the perturbation and the attacker init/order
    # again per repeat; the main CSV keeps its reference-literal header with
    # per-cell means, per-repeat rows go to a side CSV
    reps = int(fp.get("attacker_repeats", 1))
    k5 = min(5, num_classes)
    rows, rep_rows = [], []
    for sigma in fp["noise_sigmas"]:
        for mask_ratio in fp["mask_ratios"]:
            cell = []
            for r in range(reps):
                z_priv = perturb_features(generator, zs_all, float(sigma), float(mask_ratio))
                with torch.no_grad():
                    logits = model.classify_embedding(z_priv)
                top1 = top1_accuracy(logits, ys_all)
                top5 = float((logits.topk(k5, dim=1).indices == ys_all[:, None])
                             .any(dim=1).float().mean())
                ent = prediction_entropy(logits)

                _, attacker_top1 = train_attacker(
                    generator, z_priv, ys_all, num_classes,
                    epochs=int(fp.get("attacker_epochs", 10)),
                    lr=float(fp.get("attacker_lr", 1e-3)),
                    batch_size=None)
                per = privacy_exposure_rate(clean_top1, attacker_top1)
                cell.append({"top1": top1, "top5": top5, "entropy": ent,
                             "attacker_top1": attacker_top1, "per_vs_clean": per})
                rep_rows.append({"sigma": float(sigma), "mask_ratio": float(mask_ratio),
                                 "repeat": r,
                                 **{k: round(v, 6) for k, v in cell[-1].items()}})
            mean = {k: float(np.mean([c[k] for c in cell])) for k in cell[0]}
            sd = float(np.std([c["attacker_top1"] for c in cell]))
            rows.append({
                "sigma": float(sigma),
                "mask_ratio": float(mask_ratio),
                **{k: round(mean[k], 6) for k in
                   ("top1", "top5", "entropy", "attacker_top1", "per_vs_clean")},
            })
            log(f"[INFO] sigma={sigma} mask={mask_ratio} | top1={mean['top1']:.4f} "
                f"top5={mean['top5']:.4f} | attacker={mean['attacker_top1']:.4f}"
                + (f" sd={sd:.4f} (n={reps})" if reps > 1 else "")
                + f" | ent={mean['entropy']:.4f}")
            # Incremental flush: a grid run cut by a wall-clock limit keeps
            # every completed cell
            write_csv(out_csv, rows, fieldnames=list(FEATURE_FIELDS))
            if reps > 1:
                write_csv(os.path.join(save_dir, "feature_privacy_repeats.csv"),
                          rep_rows,
                          fieldnames=["sigma", "mask_ratio", "repeat", "top1",
                                      "top5", "entropy", "attacker_top1",
                                      "per_vs_clean"])

    log(f"[INFO] Saved feature privacy CSV: {out_csv}")
    if reps > 1:
        log("[INFO] Saved per-repeat privacy CSV: "
            f"{os.path.join(save_dir, 'feature_privacy_repeats.csv')}")
    return out_csv


def run(cfg: dict, log=print, device: str | torch.device | None = None) -> dict:
    """Both layers. ``device``: argument, else ``device.name``, else cuda."""
    device = common.device_from(cfg, device)
    set_seed(int(cfg.get("seed", 42)))
    save_dir = cfg.get("output", {}).get("save_dir", "results/privacy")
    ensure_dir(save_dir)
    visual_csv = run_visual_privacy(cfg, save_dir, device, log)
    feature_csv = run_feature_privacy(cfg, save_dir, device, log)
    return {"visual_csv": visual_csv, "feature_csv": feature_csv}


def main():
    p = common.make_parser("Privacy evaluation: visual + feature layers")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/privacy.yaml")
    logger = common.make_logger(cfg, "privacy")
    run(cfg, log=logger.log, device=args.device)


if __name__ == "__main__":
    main()
