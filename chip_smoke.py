#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: the flash-attention kernels K1 (forward) and K2 (backward) built
   from the repo's sources into build/kernels/, one nvcc each, in parallel;
   seconds, and registers and spills from ptxas.
3. K1 vs plain: the forward kernel against its plain PyTorch version on the
   card, at the serving slice's shapes and at the pipeline-B shapes, in fp32
   (TF32 off, tolerance 1e-4 on out and lse) and in bf16 (against the plain
   fp32 attention of the same bf16-rounded inputs, tolerance 2e-2); the
   time per call of each.
4. K2 vs plain: the backward kernel against the plain fp32 backward of the
   same inputs (and K1's out and lse), at the same shapes, in fp32 (max abs
   error of each gradient over its max magnitude, tolerance 1e-4) and bf16
   (2e-2); the time per call of each.
5. train step, kernel vs plain: the full-width TinyVideoMAE (configs/
   ssl_mae.yaml widths) at B=2 clips in fp32, TF32 off, the same weights,
   mask and drop-path decisions through the kernels and through the plain
   versions: loss to 1e-4 relative, every gradient to 1e-3 relative L2.
6. train: the port's entry.train_ssl_mae.run on configs/ssl_mae.yaml as it
   stands (batch 40, accumulation 2, remat on, bf16) on a synthetic 40-clip
   split of 64-frame 112x112 videos, random weights from a seeded
   generator, for 4 steps (2 optimizer updates). Per step: loss, gnorm,
   whether an update was applied or skipped, step ms, clips/s, K1 and K2
   calls (20 and 12 required) and peak device memory.
7. serving slice: the port's run_dynamic early-exit sweep at full MobileViT-S
   width (configs/dynamic.yaml: 101 classes, embed 256, batch 8, 16 frames,
   112x112, bf16) on a synthetic split, with random weights from a seeded
   generator, once streaming and once batched. K1's launch count in these
   runs must be a positive multiple of 6 (3 MobileViT blocks x depth 2). One
   batch is checked against the same weights run in fp32 through the plain
   path on the CPU.

Kernel launch counts are set to 0 just before each path (train, serving) is
driven and read just after. The line before the last lists the kernels;
the last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the rest of the repo beside this file, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_TPU = "ssl_vit_video_analytics_tpu/ops/flash_attention.py:147"
K1_SOURCE = "ssl_vit_video_analytics_tpu_torch/ops/csrc/flash_fwd.cu"
K2_TPU = "ssl_vit_video_analytics_tpu/ops/flash_attention.py:214"
K2_SOURCE = "ssl_vit_video_analytics_tpu_torch/ops/csrc/flash_bwd.cu"

# configs/dynamic.yaml, spelled out: the card's machine may lack yaml
# (a CPU test holds these to the file)
DYNAMIC_YAML = {
    "dataset": {"num_classes": 101},
    "model": {"embed_dim": 256},
    "dynamic": {"confidence_thresholds": [0.55, 0.65, 0.70, 0.75, 0.80, 0.85],
                "min_frames": 4, "max_frames": 16, "frame_step": 1},
    "runtime": {"batch_size": 8, "num_warmup": 10, "num_measure": 50},
}

# configs/ssl_mae.yaml (with configs/base.yaml's seed, dtype and backend),
# spelled out likewise and held to the files by a CPU test
SSL_MAE_YAML = {
    "dataset": {"clip_len": 16, "stride": 4, "image_size": 112},
    "model": {"type": "tiny_vit_21m_variant", "embed_dims": [96, 192, 384, 576],
              "decoder_embed_dim": 384, "decoder_depth": 4, "decoder_num_heads": 6},
    "ssl": {"mask_ratio": 0.9, "mask_strategy": "tube", "norm_pix_loss": True},
    "training": {"epochs": 200, "batch_size": 40, "accumulation_steps": 2, "lr": 0.0005,
                 "min_lr": 0.000001, "warmup_epochs": 40, "weight_decay": 0.05,
                 "save_every": 10, "log_interval": 20},
}
BASE_YAML = {"seed": 42, "device": {"compute_dtype": "bfloat16"},
             "dataset": {"backend": "packed"}}
TRAIN_STEPS = 4
# attention layers of the pipeline-B step: 2 in TinyViT stage 1, 6 in
# stage 2, 4 in the decoder. Each runs K1 forward and K2 backward once; the
# 8 encoder layers run K1 once more when their checkpointed stage is
# recomputed in the backward pass (the decoder is not checkpointed).
K1_CALLS_PER_STEP, K2_CALLS_PER_STEP = 12 + 8, 12

# (B, Lq, Lk, H, d): the slice's MobileViT blocks at 8 clips x 16 frames,
# then pipeline-B's TinyViT stages, its decoder, and a sequence-parallel shard
KERNEL_SHAPES = [
    ("mvit1", 128, 196, 196, 4, 32),
    ("mvit2", 128, 64, 64, 4, 40),
    ("mvit3", 128, 16, 16, 4, 48),
    ("tinyvit_stage1", 32, 784, 784, 6, 32),
    ("tinyvit_stage2", 128, 196, 196, 12, 32),
    ("mae_decoder", 4, 3136, 3136, 6, 64),
    ("decoder_seq_shard", 4, 784, 3136, 6, 64),
]
TRAIN_SHAPES = ("tinyvit_stage1", "tinyvit_stage2", "mae_decoder")
TOL_FP32, TOL_BF16 = 1e-4, 2e-2
TOL_STEP_LOSS, TOL_STEP_GRAD = 1e-4, 1e-3


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_kernel(fa, dev) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    sums = {"ms": 0.0, "plain_ms": 0.0}
    for name, B, Lq, Lk, H, d in KERNEL_SHAPES:
        hd = H * d
        # strided thirds of a fused projection, as MultiHeadAttention passes them
        qkv = torch.randn(B, Lq, 3 * hd, device=dev, generator=g)
        kv = torch.randn(B, Lk, 2 * hd, device=dev, generator=g)
        for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            qkv_t, kv_t = qkv.to(dtype), kv.to(dtype)
            q, k, v = qkv_t[..., :hd], kv_t[..., :hd], kv_t[..., hd:]
            out, lse = fa.flash_attention_fwd(q, k, v, H)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), H)
            torch.cuda.synchronize()
            err_out = (out.float() - ref_out).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            ok = (out.shape == ref_out.shape and math.isfinite(err_out)
                  and err_out <= tol and err_lse <= tol)
            ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, H))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, H))
            emit({"phase": "kernel_vs_plain", "shape": name, "B": B, "Lq": Lq, "Lk": Lk,
                  "H": H, "d": d, "dtype": str(dtype).replace("torch.", ""),
                  "err_out": err_out, "err_lse": err_lse, "tol": tol,
                  "ms": ms, "plain_ms": plain_ms, "ok": ok})
            if not ok:
                raise AssertionError(f"K1 disagrees with the plain version at {name} "
                                     f"{dtype}: out {err_out}, lse {err_lse} > {tol}")
            max_err = max(max_err, err_out, err_lse)
            if name in TRAIN_SHAPES and dtype == torch.bfloat16:
                sums["ms"] += ms
                sums["plain_ms"] += plain_ms
    return {"max_abs_err": max_err, **sums}


def phase_build(fa) -> dict:
    t0 = time.perf_counter()
    libs = fa.build()
    seconds = time.perf_counter() - t0
    out = {"phase": "build", "seconds": seconds}
    for name, kl in libs.items():
        out[name] = {"nvcc_seconds": kl.build_seconds,
                     "library": os.path.relpath(kl.path, ROOT),
                     "ptxas": ptxas_summary(kl.ptxas_log)}
    emit(out)
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation: registers, spill stores/loads."""
    rows, kernel = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_\w+?_kernel)I(\w+?)Li(\d+)E", line)
        if m:
            kernel = f"{m.group(1)}<{'bf16' if 'bfloat16' in m.group(2) else 'f32'},{m.group(3)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows.append(f"{kernel}: spill {m.group(1)}/{m.group(2)}")
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1] += f", {m.group(1)} regs"
    return rows


def rel_err(got, ref) -> float:
    """Max abs error over the reference's max magnitude."""
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def phase_backward(fa, dev) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(1)
    max_abs, max_rel = 0.0, 0.0
    sums = {"ms": 0.0, "plain_ms": 0.0}
    for name, B, Lq, Lk, H, d in KERNEL_SHAPES:
        hd = H * d
        qkv = torch.randn(B, Lq, 3 * hd, device=dev, generator=g)
        kv = torch.randn(B, Lk, 2 * hd, device=dev, generator=g)
        dout32 = torch.randn(B, Lq, hd, device=dev, generator=g)
        for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            qkv_t, kv_t, dout = qkv.to(dtype), kv.to(dtype), dout32.to(dtype)
            q, k, v = qkv_t[..., :hd], kv_t[..., :hd], kv_t[..., hd:]
            out, lse = fa.flash_attention_fwd(q, k, v, H)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, H)
            torch.cuda.synchronize()
            refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                                lse, dout.float(), H)
            torch.cuda.synchronize()
            errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, refs)}
            abs_err = max(float((a.float() - b).abs().max()) for a, b in zip(grads, refs))
            ok = (all(math.isfinite(e) and e <= tol for e in errs.values())
                  and all(a.shape == b.shape and a.dtype == dtype for a, b in zip(grads, refs)))
            ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, H))
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, H))
            emit({"phase": "k2_vs_plain", "shape": name, "B": B, "Lq": Lq, "Lk": Lk,
                  "H": H, "d": d, "dtype": str(dtype).replace("torch.", ""),
                  "rel_err": errs, "max_abs_err": abs_err, "tol": tol,
                  "ms": ms, "plain_ms": plain_ms, "ok": ok})
            if not ok:
                raise AssertionError(f"K2 disagrees with the plain backward at {name} "
                                     f"{dtype}: {errs} > {tol}")
            max_abs, max_rel = max(max_abs, abs_err), max(max_rel, *errs.values())
            if name in TRAIN_SHAPES and dtype == torch.bfloat16:
                sums["ms"] += ms
                sums["plain_ms"] += plain_ms
            del grads, refs
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, **sums}


def ssl_mae_cfg(split: str, save_dir: str) -> dict:
    cfg = json.loads(json.dumps(SSL_MAE_YAML))
    cfg["seed"] = BASE_YAML["seed"]
    cfg["device"] = {"name": "cuda", **BASE_YAML["device"]}
    cfg["dataset"].update(train_split=split, **BASE_YAML["dataset"])
    cfg["training"]["save_dir"] = save_dir
    cfg["paths"] = {"split_root": ""}
    return cfg


def phase_train_step(fa, dev) -> dict:
    """One full-width fp32 forward+backward through the kernels and through
    the plain versions, on the same weights, mask and drop-path decisions."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.masking import get_tube_mask
    from ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae import build_model
    from ssl_vit_video_analytics_tpu_torch.models.layers import MultiHeadAttention
    from ssl_vit_video_analytics_tpu_torch.ops.patchify import patchify
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train.finetune_engine import init_model
    from ssl_vit_video_analytics_tpu_torch.train.losses import mae_loss_l2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ssl_mae_cfg("", "")
    B, T, S = 2, cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    L = (S // 8) ** 2
    model = build_model(cfg, torch.float32)
    init_model(model, torch.Generator().manual_seed(0))
    model.to(dev).train()
    g = torch.Generator(device=dev).manual_seed(2)
    clip = normalize_clip(torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8,
                                        device=dev, generator=g))
    mask = get_tube_mask(g, B, T, L, cfg["ssl"]["mask_ratio"])
    drop = model.draw_drop_path(B, T, g)
    target = patchify(clip, 8)
    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]
    res = {}
    for impl in ("kernel", "plain", "kernel", "plain"):  # the first pass of each warms up
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attn_impl = impl
        fa.launches.reset()
        fa.bwd_launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = mae_loss_l2(model(clip, mask, drop), target, mask.reshape(B, T * L))
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        res[impl] = {"loss": float(loss.detach()), "grads": grads,
                     "ms": 1e3 * (time.perf_counter() - t0),
                     "k1": fa.launches.count, "k2": fa.bwd_launches.count}
    kern, plain = res["kernel"], res["plain"]
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    # A gradient that is zero in exact arithmetic is rounding noise in both
    # runs: a per-channel shift ahead of a train-mode BatchNorm (the biases
    # of stage 0's residual MBConvs, whose zero-scale BN adds only its bias,
    # and of the stem) is taken out again by the next BN's batch mean. Each
    # gradient's difference is therefore measured against its own norm, but
    # not against less than 1e-4 of the largest gradient norm.
    norms = [float(b.norm()) for b in plain["grads"]]
    floor = 1e-4 * max(norms)
    worst, worst_name, floored = 0.0, "", 0
    for name, a, b, nb in zip(names, kern["grads"], plain["grads"], norms):
        rel = float((a - b).norm()) / max(nb, floor)
        floored += nb < floor
        if not math.isfinite(rel) or rel > worst:
            worst, worst_name = rel, name
    out = {"phase": "train_step_kernel_vs_plain", "B": B, "T": T, "dtype": "float32",
           "loss_kernel": kern["loss"], "loss_plain": plain["loss"], "loss_rel": loss_rel,
           "worst_grad_rel_l2": worst, "worst_grad": worst_name,
           "grads": len(names), "grads_below_floor": floored, "grad_norm_floor": floor,
           "ms_kernel": kern["ms"], "ms_plain": plain["ms"],
           "k1_calls": kern["k1"], "k2_calls": kern["k2"],
           "plain_k1_k2": [plain["k1"], plain["k2"]]}
    emit(out)
    if not (loss_rel <= TOL_STEP_LOSS and worst <= TOL_STEP_GRAD and math.isfinite(worst)):
        raise AssertionError(f"kernel vs plain step: loss rel {loss_rel}, grad {worst_name} "
                             f"rel L2 {worst}")
    if (kern["k1"], kern["k2"], plain["k1"], plain["k2"]) != (
            K1_CALLS_PER_STEP, K2_CALLS_PER_STEP, 0, 0):
        raise AssertionError(f"kernel calls in the step: {out}")
    return out


def phase_train(fa, dev) -> dict:
    """The pipeline-B entry on configs/ssl_mae.yaml for TRAIN_STEPS steps."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
    from ssl_vit_video_analytics_tpu_torch.train.state import adamw_of
    from ssl_vit_video_analytics_tpu_torch.utils.metrics import (
        pipeline_b_flops_per_clip, pipeline_b_model_kwargs)

    B = SSL_MAE_YAML["training"]["batch_size"]
    k = SSL_MAE_YAML["training"]["accumulation_steps"]
    d = SSL_MAE_YAML["dataset"]
    # model FLOPs (forward + backward, no recompute) per clip, analytic
    flops_per_clip = pipeline_b_flops_per_clip(d["clip_len"], d["image_size"],
                                               **pipeline_b_model_kwargs(SSL_MAE_YAML))
    with tempfile.TemporaryDirectory() as tmp:
        # 8 classes x 5 train videos = 40 clips of 64 frames (16 frames at
        # stride 4), 112x112
        splits = make_synthetic_dataset(os.path.join(tmp, "data"), num_classes=8,
                                        videos_per_class=6, num_frames=64,
                                        image_size=112, seed=0)
        cfg = ssl_mae_cfg(splits["train"], os.path.join(tmp, "out"))
        steps, last = [], {"t": 0.0, "count": 0}
        final = {}

        def on_step(i, state, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            count = adamw_of(state.tx).count
            due = i % k == 0
            steps.append({"step": i, "includes_setup": i == 1,
                          "loss": float(metrics["loss"]),
                          "gnorm": float(metrics["grad_norm"]),
                          "update": ("applied" if count > last["count"] else "skipped")
                          if due else "accumulated",
                          "step_ms": 1e3 * (now - last["t"]),
                          "clips_per_s": B / (now - last["t"]),
                          "model_tflop_per_s": flops_per_clip * B / (now - last["t"]) / 1e12,
                          "k1_calls": fa.launches.count, "k2_calls": fa.bwd_launches.count,
                          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
            emit({"phase": "train_step", **steps[-1]})
            final["model"], final["count"] = state.model, count
            fa.launches.reset()
            fa.bwd_launches.reset()
            torch.cuda.reset_peak_memory_stats()
            last["count"] = count
            last["t"] = time.perf_counter()

        torch.cuda.reset_peak_memory_stats()
        lines = []
        fa.launches.reset()
        fa.bwd_launches.reset()
        last["t"] = t0 = time.perf_counter()
        out = train_ssl_mae.run(cfg, log=lines.append, max_steps=TRAIN_STEPS,
                                on_step=on_step)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(p).all()) for p in final["model"].parameters())
    summary = {"phase": "train", "steps": out["steps"], "seconds": seconds,
               "last_loss": out["last_loss"], "updates_applied": final["count"],
               "params_finite": finite, "log": lines[-3:]}
    emit(summary)
    bad = [s for s in steps if (s["k1_calls"], s["k2_calls"])
           != (K1_CALLS_PER_STEP, K2_CALLS_PER_STEP)]
    if out["steps"] != TRAIN_STEPS or bad:
        raise AssertionError(f"train: {out['steps']} steps; kernel calls off in {bad}")
    if not (finite and final["count"] >= 1 and all(math.isfinite(s["loss"]) for s in steps)):
        raise AssertionError(f"train: non-finite result or no update applied: {summary}")
    return {"k1": sum(s["k1_calls"] for s in steps), "k2": sum(s["k2_calls"] for s in steps)}


def slice_cfg(split: str, save_dir: str, impl: str) -> dict:
    cfg = json.loads(json.dumps(DYNAMIC_YAML))
    cfg["seed"] = 42
    cfg["device"] = {"name": "cuda", "compute_dtype": "bfloat16"}
    cfg["dataset"].update({"split": split, "backend": "packed", "clip_len": 16,
                           "stride": 2, "image_size": 112})
    cfg["model"]["finetune_ckpt"] = None  # random weights, seeded generator
    cfg["dynamic"].update({"mode": "early_exit", "early_exit_impl": impl})
    cfg["paths"] = {"split_root": ""}
    cfg["output"] = {"save_dir": save_dir, "save_csv": True}
    return cfg


def check_rows(rows: list[dict], impl: str) -> None:
    from ssl_vit_video_analytics_tpu_torch.entry.run_dynamic import EARLY_EXIT_FIELDS

    thresholds = DYNAMIC_YAML["dynamic"]["confidence_thresholds"]
    if len(rows) != len(thresholds):
        raise AssertionError(f"{impl}: {len(rows)} rows for {len(thresholds)} thresholds")
    for row, thr in zip(rows, thresholds):
        if tuple(row) != EARLY_EXIT_FIELDS or row["threshold"] != f"{thr:.2f}":
            raise AssertionError(f"{impl}: malformed row {row}")
        values = {k: float(v) for k, v in row.items()}
        if not all(math.isfinite(x) for x in values.values()):
            raise AssertionError(f"{impl}: non-finite row {row}")
        if not (0 <= values["top1"] <= values["top5"] <= 1
                and DYNAMIC_YAML["dynamic"]["min_frames"] <= values["avg_frames"]
                <= DYNAMIC_YAML["dynamic"]["max_frames"]
                and 0 < values["avg_conf"] <= 1 and values["avg_latency_ms"] > 0):
            raise AssertionError(f"{impl}: row out of range {row}")


def phase_slice(fa, dev) -> dict:
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.data.loader import iterate_batches
    from ssl_vit_video_analytics_tpu_torch.entry import common, run_dynamic
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        splits = make_synthetic_dataset(os.path.join(tmp, "data"), num_classes=32,
                                        videos_per_class=2, num_frames=32,
                                        image_size=112, seed=0)
        rows_by_impl = {}
        for impl in ("streaming", "batched"):
            cfg = slice_cfg(splits["val"], os.path.join(tmp, f"out_{impl}"), impl)
            fa.launches.reset()
            t0 = time.perf_counter()
            out = run_dynamic.run(cfg, mode="early_exit", log=lambda m: None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[impl] = fa.launches.count
            rows = out["rows"]
            check_rows(rows, impl)
            if launches[impl] <= 0 or launches[impl] % 6:
                raise AssertionError(f"{impl}: K1 launched {launches[impl]} times, "
                                     "not a positive multiple of 6")
            rows_by_impl[impl] = rows
            emit({"phase": "slice", "impl": impl, "k1_launches": launches[impl],
                  "seconds": seconds,
                  "avg_latency_ms": {r["threshold"]: float(r["avg_latency_ms"]) for r in rows},
                  "avg_frames": {r["threshold"]: float(r["avg_frames"]) for r in rows},
                  "top1": {r["threshold"]: float(r["top1"]) for r in rows}})
        frames = {impl: [r["avg_frames"] for r in rows] for impl, rows in rows_by_impl.items()}
        if frames["streaming"] != frames["batched"]:
            raise AssertionError(f"streaming and batched avg_frames differ: {frames}")

        # bf16 on the card (K1) vs the same weights in fp32 on the CPU (plain
        # path), batch by batch over the whole split: with random weights the
        # 101 logits sit close together, so the required argmax agreement is
        # taken over all 512 frames; the 32 clips' agreement is reported
        cfg = slice_cfg(splits["val"], tmp, "streaming")
        ds = common.dataset_from_cfg(cfg, splits["val"], "supervised")
        gpu = run_dynamic._load_classifier(cfg, torch.bfloat16, dev, lambda m: None)
        cpu = run_dynamic._load_classifier(cfg, torch.float32, torch.device("cpu"),
                                           lambda m: None)
        T = DYNAMIC_YAML["dynamic"]["max_frames"]
        B = DYNAMIC_YAML["runtime"]["batch_size"]
        lg, lc, clip_lg, clip_lc = [], [], [], []
        fa.launches.reset()
        with torch.inference_mode():
            for batch in iterate_batches(ds, B, shuffle=False, seed=0, epoch=0,
                                         drop_last=False):
                raw = torch.from_numpy(batch["clip"])[:, :T]
                frames_u8 = raw.reshape((-1,) + tuple(raw.shape[2:]))  # [B*T, H, W, 3]
                emb = gpu.frame_embedding(normalize_clip(frames_u8.to(dev)))
                lg.append(gpu.classify_embedding(emb).float().cpu())
                clip_lg.append(gpu(normalize_clip(raw.to(dev))).float().cpu())
                emb_c = cpu.frame_embedding(normalize_clip(frames_u8))
                lc.append(cpu.classify_embedding(emb_c))
                # the classifier's forward is the head on the mean frame embedding
                clip_lc.append(cpu.classify_embedding(emb_c.reshape(len(raw), T, -1).mean(1)))
        torch.cuda.synchronize()
        if fa.launches.count <= 0:
            raise AssertionError("the bf16 check did not go through K1")
        lg, lc, clip_lg, clip_lc = (torch.cat(x) for x in (lg, lc, clip_lg, clip_lc))
        agree = float((lg.argmax(1) == lc.argmax(1)).float().mean())
        clip_agree = float((clip_lg.argmax(1) == clip_lc.argmax(1)).float().mean())
        emit({"phase": "slice_vs_cpu_fp32", "frames": int(lg.shape[0]),
              "max_abs_diff": (lg - lc).abs().max().item(),
              "logit_scale": lc.abs().max().item(), "argmax_agreement": agree,
              "clips": int(clip_lg.shape[0]),
              "clip_max_abs_diff": (clip_lg - clip_lc).abs().max().item(),
              "clip_argmax_agreement": clip_agree})
        if not (torch.isfinite(lg).all() and torch.isfinite(clip_lg).all()
                and agree >= 0.95):
            raise AssertionError(f"bf16 card logits vs fp32 CPU: argmax agreement "
                                 f"{agree} over {len(lg)} frames < 0.95")
    return launches


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run "
                         "needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "device_name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    phase_build(fa)
    k1 = phase_kernel(fa, dev)
    k2 = phase_backward(fa, dev)
    phase_train_step(fa, dev)
    train = phase_train(fa, dev)
    serving = phase_slice(fa, dev)

    ms_is = ("sum over the pipeline-B shapes (tinyvit_stage1, tinyvit_stage2, "
             "mae_decoder) in bf16, one call each")
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_TPU, "launches": train["k1"],
         "launches_by_path": {"train_ssl_mae": train["k1"],
                              "run_dynamic_streaming": serving["streaming"],
                              "run_dynamic_batched": serving["batched"]},
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "ms_is": ms_is},
        {"name": "flash_attention_bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_TPU, "launches": train["k2"],
         "launches_is": "calls, each launching the dK/dV and the dQ kernel",
         "max_abs_err": k2["max_abs_err"], "max_rel_err": k2["max_rel_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "ms_is": ms_is},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
