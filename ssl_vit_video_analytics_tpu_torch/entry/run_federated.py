"""Federated FedAvg CLI (counterpart of the JAX package's
``entry/run_federated.py``; reference: src/run_federated.py).

Pipeline: centralized same-budget baseline -> non-IID class-shard client
splits (+ stats CSV) -> FedAvg rounds -> fed_summary.csv +
system_privacy_summary.csv (raw-upload counterfactual vs FL comm).

On one card the selected clients train one after another from the global
state (``federated/core.py``), as the JAX package does without a mesh.
Under ``torchrun`` the clients ride a ``client`` mesh over every rank, as
the JAX entry's mesh over all its devices: each rank runs its block of the
round's clients and the aggregate is an all-reduce. The centralized
baseline and the validation run whole on every rank (JAX runs them on one
device); rank 0 alone writes the split files and the CSVs. CSV headers and
float formats match the reference (ref: :325-363).

    python -m ssl_vit_video_analytics_tpu_torch.entry.run_federated \\
        --config configs/federated.yaml --device cuda
    torchrun --standalone --nproc_per_node 8 \\
        -m ssl_vit_video_analytics_tpu_torch.entry.run_federated --config configs/federated.yaml
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..data.splits import make_class_shard_splits
from ..federated import (
    make_parallel_client_update, run_fedavg, estimate_raw_upload_mb,
)
from ..ops.preprocess import normalize_clip
from ..parallel import mesh as pmesh
from ..train import finetune_engine as eng
from ..train.state import create_train_state
from ..utils.checkpoint import checkpoint_path, read_checkpoint
from ..utils.io import write_csv, ensure_dir
from ..utils.prng import set_seed
from . import common

# CSV headers, byte-compatible with the reference outputs
# (ref: src/run_federated.py:343-349, :361-363; src/train_centralized :172-180)
FED_SUMMARY_FIELDS = ("round", "val_top1", "val_top5", "avg_local_loss",
                      "clients", "model_mb", "comm_mb_round", "comm_mb_total")
CENTRALIZED_FIELDS = ("epoch", "train_loss", "val_top1", "val_top5")
SYSTEM_PRIVACY_FIELDS = ("raw_upload_mb_est", "fed_comm_total_mb", "reduction_ratio")


def _build_round_sampler(client_datasets, batch_size: int, local_epochs: int,
                         clip_shape, seed: int):
    """Returns sample_round_batches(selected, round) -> (batches dict, sizes).

    Stacks per-client batch streams [N, S, B, ...] padded to the longest
    client (ragged tails masked via 'valid'), host arrays bit-equal to the
    JAX package's.
    """
    T, S_img = clip_shape

    def sample(selected: list[int], rnd: int):
        per_client = []
        sizes = []
        for cid in selected:
            ds = client_datasets[cid]
            n = len(ds)
            sizes.append(float(n))
            order = []
            rng = np.random.default_rng(seed + 1000 * rnd + cid)
            for _ in range(local_epochs):
                order.extend(rng.permutation(n).tolist())
            steps = max(1, math.ceil(len(order) / batch_size))
            clips = np.zeros((steps, batch_size, T, S_img, S_img, 3), np.uint8)
            labels = np.zeros((steps, batch_size), np.int32)
            valid = np.zeros((steps, batch_size), bool)
            for s in range(steps):
                chunk = order[s * batch_size:(s + 1) * batch_size]
                for j, idx in enumerate(chunk):
                    clips[s, j] = ds.get_clip(int(idx))
                    labels[s, j] = ds.label(int(idx))
                    valid[s, j] = True
            per_client.append((clips, labels, valid))
        S_max = max(pc[0].shape[0] for pc in per_client)
        Nc = len(selected)
        clips = np.zeros((Nc, S_max, batch_size, T, S_img, S_img, 3), np.uint8)
        labels = np.zeros((Nc, S_max, batch_size), np.int32)
        valid = np.zeros((Nc, S_max, batch_size), bool)
        for i, (c, l, v) in enumerate(per_client):
            clips[i, :c.shape[0]] = c
            labels[i, :l.shape[0]] = l
            valid[i, :v.shape[0]] = v
        return ({"clip": clips, "label": labels, "valid": valid},
                np.asarray(sizes, np.float32))

    return sample


def _build_model(cfg: dict, dtype: torch.dtype, seed: int, device: torch.device):
    """The MobileViT-S classifier of ``model.*``, flax-like init from ``seed``."""
    model = eng.build_model(int(cfg["dataset"]["num_classes"]), int(cfg["model"]["embed_dim"]),
                            dtype=dtype,
                            backbone=str(cfg["model"].get("backbone", "mobilevit_s")))
    return eng.init_model(model, torch.Generator().manual_seed(seed)).to(device)


def _centralized_baseline(cfg: dict, train_split: str, val_ds, out_dir: str,
                          device: torch.device, log):
    c_cfg = cfg.get("centralized", {})
    if not bool(c_cfg.get("enabled", True)):
        return None
    fed = cfg["federated"]
    epochs = int(c_cfg.get("epochs") or int(fed["rounds"]) * int(fed["local_epochs"]))
    tr_cfg = {
        "learning_rate": float(c_cfg.get("lr", fed["lr"])),
        "weight_decay": float(c_cfg.get("weight_decay", fed["weight_decay"])),
        "grad_clip": None,  # reference client_sim.py does not clip
    }
    dtype = common.compute_dtype_from(cfg, device)
    seed = int(cfg.get("seed", 42))
    B = int(c_cfg.get("batch_size", fed["batch_size"]))
    train_ds = common.maybe_device_resident(
        cfg, common.dataset_from_cfg(cfg, train_split, "supervised", seed=seed + 123),
        device, log, batch_size=B)
    model = _build_model(cfg, dtype, seed, device)
    state = create_train_state(model, eng.build_finetune_tx(tr_cfg, "ft_random", model, False))
    train_step = eng.make_train_step(model, compute_dtype=dtype)
    eval_step = eng.make_eval_step(model, compute_dtype=dtype)
    step_gen = torch.Generator(device=device).manual_seed(seed)

    rows = []
    for ep in range(1, int(epochs) + 1):
        losses = []  # device scalars, fetched once per epoch
        for batch in common.epoch_batches(train_ds, B, shuffle=True, seed=seed + 123,
                                          epoch=ep, device=device):
            state, metrics = train_step(state, batch, step_gen)
            losses.append(metrics["loss"])
        acc = eng.evaluate(eval_step, common.epoch_batches(
            val_ds, B, shuffle=False, seed=0, epoch=0, device=device, drop_last=False))
        avg_loss = sum(torch.stack(losses).tolist()) / max(1, len(losses)) if losses else 0.0
        log(f"[INFO][Centralized] ep={ep}/{epochs} train_loss={avg_loss:.4f} "
            f"val_top1={acc['top1']:.4f} val_top5={acc['top5']:.4f}")
        rows.append({"epoch": ep, "train_loss": round(avg_loss, 6),
                     "val_top1": round(acc["top1"], 6), "val_top5": round(acc["top5"], 6)})
    out_csv = os.path.join(out_dir, "centralized_summary.csv")
    if pmesh.is_main():
        write_csv(out_csv, rows, fieldnames=list(CENTRALIZED_FIELDS))
        log(f"[INFO] Saved centralized summary: {out_csv}")
    return rows


def run(cfg: dict, log=print, device: str | torch.device | None = None) -> dict:
    """Baseline, splits, FedAvg rounds and the CSVs. ``device``: argument,
    else ``device.name``, else cuda (under a launcher, this rank's card).
    Returns ``{"records", "fed_csv"}``."""
    device = common.init_distributed(cfg, device, log)
    W = pmesh.world_size()
    mesh = pmesh.make_mesh({"client": W}) if W > 1 else None
    main = pmesh.is_main()
    seed = int(cfg.get("seed", 42))
    set_seed(seed)
    dtype = common.compute_dtype_from(cfg, device)
    fed = cfg["federated"]
    out_dir = cfg.get("output", {}).get("save_dir", "results/privacy/federated")
    if main:
        ensure_dir(out_dir)
    B = int(fed["batch_size"])

    d = cfg["dataset"]
    train_split = common.split_path(cfg, d["train_split"])
    val_ds = common.maybe_device_resident(
        cfg, common.dataset_from_cfg(cfg, common.split_path(cfg, d["val_split"]),
                                     "supervised", seed=seed + 999),
        device, log, batch_size=B)

    # centralized same-budget baseline
    _centralized_baseline(cfg, train_split, val_ds, out_dir, device, log)

    # non-IID class-shard client splits + stats CSV
    non_iid = fed.get("non_iid", {})
    num_clients = int(fed["num_clients"])
    split_dir = cfg.get("paths", {}).get("split_root", "data/splits")
    paths, stats = make_class_shard_splits(
        train_split, num_clients,
        shards_per_client=int(non_iid.get("shards_per_client", 6)),
        seed=seed,
        min_samples_per_client=int(non_iid.get("min_samples_per_client", 200)),
        out_prefix=str(cfg.get("output", {}).get("split_prefix", "fed")),
        out_dir=split_dir, write=main)
    pmesh.barrier()  # rank 0's split files are on disk for every rank
    if main:
        write_csv(os.path.join(out_dir, "fed_client_stats.csv"), stats)
    log(f"[INFO] client splits: {[s['num_samples'] for s in stats]}")

    client_datasets = [
        common.dataset_from_cfg(cfg, p, "supervised", seed=seed + i)
        for i, p in enumerate(paths)
    ]

    # global model
    model = _build_model(cfg, dtype, seed, device)
    init_ckpt = cfg["model"].get("init_ckpt")
    if init_ckpt and checkpoint_path(init_ckpt):
        model.load_state_dict(read_checkpoint(init_ckpt))
        log(f"[INFO] warm start from {init_ckpt}")
    pmesh.broadcast_module(model, mesh)
    log(f"[INFO] mesh: {mesh} (clients={num_clients}, devices={W})")

    step_chunk = fed.get("step_chunk")  # None = auto-size to 512 MiB of clips
    parallel_update = make_parallel_client_update(
        model, lr=float(fed["lr"]), weight_decay=float(fed["weight_decay"]),
        normalize_fn=lambda c: normalize_clip(c, dtype=dtype),
        step_chunk=int(step_chunk) if step_chunk else None)

    eval_step = eng.make_eval_step(model, compute_dtype=dtype)

    def evaluate_fn(state):
        model.load_state_dict(state)
        acc = eng.evaluate(eval_step, common.epoch_batches(
            val_ds, B, shuffle=False, seed=0, epoch=0, device=device, drop_last=False))
        return acc["top1"], acc["top5"]

    sampler = _build_round_sampler(
        client_datasets, B, int(fed["local_epochs"]),
        (val_ds.clip_len, val_ds.image_size), seed)

    global_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    records, _ = run_fedavg(
        parallel_update, global_state, sampler, evaluate_fn, num_clients,
        rounds=int(fed["rounds"]),
        client_fraction=float(fed.get("client_fraction", 1.0)), log=log, mesh=mesh)

    # fed_summary.csv with cumulative comm
    comm_total = 0.0
    rows = []
    for r in records:
        comm_total += float(r["comm_mb_round"])
        rows.append({
            "round": r["round"],
            "val_top1": round(float(r["val_top1"]), 6),
            "val_top5": round(float(r["val_top5"]), 6),
            "avg_local_loss": round(float(r["avg_local_loss"]), 6),
            "clients": int(r["clients"]),
            "model_mb": round(float(r["model_mb"]), 6),
            "comm_mb_round": round(float(r["comm_mb_round"]), 6),
            "comm_mb_total": round(float(comm_total), 6),
        })
    fed_csv = os.path.join(out_dir, "fed_summary.csv")
    if main:
        write_csv(fed_csv, rows, fieldnames=list(FED_SUMMARY_FIELDS))
        log(f"[INFO] Saved federated summary: {fed_csv}")

    # system-level privacy proxy
    sp = cfg.get("system_privacy", {})
    raw_mb = None
    if bool(sp.get("estimate_raw_upload", True)):
        with open(train_split) as f:
            n_samples = sum(1 for line in f if line.strip())
        raw_mb = estimate_raw_upload_mb(
            n_samples, val_ds.clip_len, val_ds.image_size,
            bytes_per_value=int(sp.get("raw_dtype_bytes", 1)))
    sys_rows = [{
        "raw_upload_mb_est": round(raw_mb, 6) if raw_mb is not None else "",
        "fed_comm_total_mb": round(comm_total, 6),
        "reduction_ratio": round(comm_total / raw_mb, 6) if raw_mb else "",
    }]
    sys_csv = os.path.join(out_dir, "system_privacy_summary.csv")
    if main:
        write_csv(sys_csv, sys_rows, fieldnames=list(SYSTEM_PRIVACY_FIELDS))
        log(f"[INFO] Saved system privacy summary: {sys_csv}")
    return {"records": rows, "fed_csv": fed_csv}


def main():
    p = common.make_parser("Federated FedAvg over the ranks' client axis")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/federated.yaml")
    logger = common.make_logger(cfg, "federated")
    with pmesh.process_group_scope():
        run(cfg, log=logger.log, device=args.device)


if __name__ == "__main__":
    main()
