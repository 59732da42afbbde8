"""d=128 decoder head repack probe (counterpart of the JAX package's
``scripts/probe_decoder_repack.py``).

The pipeline-B decoder runs 6 heads of d=64 over T*196=3136 tokens
(ref: src/models/mae_vit_adapter.py:40-48 uses nhead=6 at decoder_dim 384).
The repack runs the same decoder as 3 heads of d=128: the qkv and proj
weights are head-count independent ([D, 3D] packed), so it is a different
attention function over the same parameters. On the card both go through
the port's flash kernels K1/K2, which take every head dim up to 256. This
probe measures

  (a) step time, decoder_num_heads=6 (d=64) vs 3 (d=128), the full
      pipeline-B train step at production shapes (TinyViT-21M encoder,
      decoder 384 wide and 4 deep, B=16 clips of 16 x 112^2, mask 0.9,
      norm-pix, AdamW without clipping, bf16), built through
      ``entry/train_ssl_mae.build_model`` and ``train/mae_engine
      .make_pixel_mae_step``;
  (b) the loss trajectories of both from IDENTICAL initial weights and the
      same batches, masks and drop-path draws.

Opt-in: the repack is just ``--set model.decoder_num_heads=3`` on
``entry.train_ssl_mae``; nothing else changes.

It reads the hard fixture that ``scripts/mae_evidence`` writes (``--data``).

Run (card): python -m ssl_vit_video_analytics_tpu_torch.scripts.probe_decoder_repack [--steps 60]

Like the JAX probe it refuses to run off the card; ``--device cpu`` is for
the CPU test, which drives :func:`compare` at toy widths.
"""
from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from ..entry import train_ssl_mae
from ..train.finetune_engine import init_model
from ..train.mae_engine import make_pixel_mae_step, wrap_accum_and_skip
from ..train.state import create_train_state, make_optimizer, warmup_cosine_schedule

DECODER_DIM = 384


def run_arm(num_heads: int, clips: np.ndarray, batch: int, steps: int,
            device: torch.device, embed_dims=(96, 192, 384, 576),
            decoder_depth: int = 4) -> tuple[np.ndarray, float]:
    """``steps`` timed pipeline-B steps (after one warm-up step) with the
    decoder's ``num_heads``; returns the per-step losses and ms a step.
    Every draw is seeded, so two arms see the same weights, batches, masks
    and drop-path decisions."""
    T, S = clips.shape[1], clips.shape[2]
    cfg = {"model": {"type": "tiny_vit_21m_variant", "embed_dims": list(embed_dims),
                     "decoder_embed_dim": DECODER_DIM, "decoder_depth": decoder_depth,
                     "decoder_num_heads": num_heads, "use_checkpoint": False},
           "dataset": {"clip_len": T, "image_size": S}}
    model = train_ssl_mae.build_model(cfg, torch.bfloat16)
    init_model(model, torch.Generator().manual_seed(0))
    model.to(device)
    sched = warmup_cosine_schedule(5e-4, 10, steps, 0.0)
    tx = wrap_accum_and_skip(make_optimizer(model.parameters(), sched, weight_decay=0.05,
                                            grad_clip=None), 1)
    state = create_train_state(model, tx)
    step_fn = make_pixel_mae_step(model, mask_ratio=0.9, patch_size=8, norm_pix_loss=True,
                                  compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(1)
    batch_of = lambda idx: {"clip": torch.from_numpy(clips[idx]).to(device)}  # noqa: E731
    # warm-up (cuDNN plans, the kernels' first launch) outside the timed window
    state, m_w = step_fn(state, batch_of(np.arange(batch)),
                         torch.Generator(device=device).manual_seed(2))
    float(m_w["loss"])
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, batch_of(rng.integers(0, len(clips), batch)), gen)
        losses.append(m["loss"])  # a device scalar: no host sync inside the window
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / steps * 1e3
    losses = np.asarray([float(v) for v in losses])
    print(f"[heads={num_heads} d={DECODER_DIM // num_heads}] {dt:.1f} ms/step "
          f"({batch / dt * 1e3:.1f} clips/s) "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return losses, dt


def compare(clips: np.ndarray, batch: int, steps: int, device: torch.device,
            reverse: bool = False, **arm_kwargs) -> dict:
    """Both arms (6x64 first, or 3x128 first with ``reverse``) and the JAX
    probe's summary lines; returns the numbers those lines print."""
    order = (3, 6) if reverse else (6, 3)
    out = {h: run_arm(h, clips, batch, steps, device, **arm_kwargs) for h in order}
    (l6, t6), (l3, t3) = out[6], out[3]
    rel = np.abs(l3 - l6) / np.maximum(np.abs(l6), 1e-9)
    print(f"step time: 6x64 {t6:.1f} ms vs 3x128 {t3:.1f} ms "
          f"({(t6 - t3) / t6 * 100:+.1f}% from repack)")
    print(f"trajectory deviation (different attention fn, same init): "
          f"max {rel.max():.2%}, mean {rel.mean():.2%}")
    print("6x64: ", " ".join(f"{v:.3f}" for v in l6[::10]))
    print("3x128:", " ".join(f"{v:.3f}" for v in l3[::10]))
    return {"ms_6x64": t6, "ms_3x128": t3, "losses_6x64": l6, "losses_3x128": l3,
            "max_rel_dev": float(rel.max()), "mean_rel_dev": float(rel.mean())}


def load_clips(data: str, image_size: int = 112, limit: int = 64) -> np.ndarray:
    paths = sorted(glob.glob(os.path.join(data, f"class*/vid*/packed_{image_size}.npy")))
    if not paths:
        raise SystemExit(f"no packed fixture under {data}; run "
                         "ssl_vit_video_analytics_tpu_torch.scripts.mae_evidence once "
                         "to create it")
    return np.stack([np.load(p) for p in paths[:limit]])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--data", default="/tmp/ssl_campaign/data",
                   help="hard-fixture root (scripts/mae_evidence.py default)")
    p.add_argument("--reverse", action="store_true",
                   help="run 3x128 first (order-effect control)")
    p.add_argument("--device", default="cuda", help="cuda (the probe), or cpu for tests")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chip-only probe: production 112^2 shapes are not "
                         "meaningful (or tractable) on the CPU host")
    return compare(load_clips(args.data), args.batch, args.steps, device,
                   reverse=args.reverse)


if __name__ == "__main__":
    main()
