"""Shared runtime plumbing for the CLI entry points (the single-device parts
of the JAX package's ``entry/common.py``): config and device resolution, the
device-resident split, epoch batches, and the refusal of the JAX knobs the
port does not have (multi-device runs, step tracing, on-device
augmentation)."""
from __future__ import annotations

import argparse
import os

import torch

from ..data.device_store import ChunkedDeviceClipStore, DeviceClipStore
from ..data.loader import ClipDataset, iterate_batches, prefetch_to_device, to_device
from ..utils.config import load_config
from ..utils.io import Logger, ensure_dir


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, required=False)
    p.add_argument("--base", type=str, default="configs/base.yaml")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override: key.path=value (repeatable)")
    return p


def load_merged_config(args, default_config: str) -> dict:
    return load_config(args.config or default_config, base=args.base,
                       overrides=args.overrides)


def device_from(cfg: dict, device: str | torch.device | None = None) -> torch.device:
    """``device`` if given, else ``device.name`` of the config, else cuda;
    raises for cuda when no card is there."""
    device = torch.device(device or cfg.get("device", {}).get("name", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    return device


def refuse_unported(cfg: dict) -> None:
    """Raise on a knob of the JAX entries that the port does not have: the
    multi-device layouts, the profiler trace of the first steps and the
    on-device augmentation of the finetune step."""
    dev = cfg.get("device", {})
    knobs = {
        "device.model_parallel": int(dev.get("model_parallel", 1) or 1) > 1,
        "device.pipeline_parallel": int(dev.get("pipeline_parallel", 1) or 1) > 1,
        "device.expert_parallel": int(dev.get("expert_parallel", 1) or 1) > 1,
        "model.sequence_parallel": bool(cfg.get("model", {}).get("sequence_parallel")
                                        or dev.get("sequence_parallel")),
        "device.data_parallel": (not isinstance(dev.get("data_parallel", "auto"), (bool, str))
                                 and int(dev.get("data_parallel") or 1) > 1),
    }
    for knob, on in knobs.items():
        if on:
            raise NotImplementedError(
                f"{knob} is not ported yet: multi-GPU training arrives with ROADMAP "
                "queue 1, item 15 (this entry runs on one device)")
    if cfg.get("logging", {}).get("profile_dir"):
        raise NotImplementedError("logging.profile_dir is not ported yet: tracing the "
                                  "train step arrives with ROADMAP queue 1, item 8")
    if cfg.get("training", {}).get("augment"):
        raise NotImplementedError("training.augment is not ported yet: on-device "
                                  "augmentation (ops/augment.py) arrives with ROADMAP "
                                  "queue 1, item 15")


def compute_dtype_from(cfg: dict, device: torch.device) -> torch.dtype:
    name = str(cfg.get("device", {}).get("compute_dtype", "bfloat16")).lower()
    if device.type == "cpu" and name == "bfloat16":
        # CPU (tests / smoke): bf16 is emulated and slow; fp32 is exact
        return torch.float32
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(name, torch.float32)


def dataset_from_cfg(cfg: dict, split_file: str, mode: str,
                     seed: int | None = None) -> ClipDataset:
    d = cfg["dataset"]
    return ClipDataset(
        split_file=split_file,
        mode=mode,
        clip_len=int(d.get("clip_len", 16)),
        stride=int(d.get("stride", 2)),
        image_size=int(d.get("image_size", 112)),
        seed=int(seed if seed is not None else cfg.get("seed", 42)),
        backend=str(d.get("backend", "packed")),
    )


def split_path(cfg: dict, name: str) -> str:
    """Resolve a split name against paths.split_root unless already a path."""
    if os.path.sep in name or os.path.exists(name):
        return name
    return os.path.join(cfg.get("paths", {}).get("split_root", "data/splits"), name)


def epoch_batches(dataset, batch_size: int, shuffle: bool, seed: int, epoch: int,
                  device: torch.device, drop_last: bool = True):
    """One epoch's batches on ``device``: gathers from a device-resident
    store, or the host path with its background prefetch."""
    if isinstance(dataset, (DeviceClipStore, ChunkedDeviceClipStore)):
        return dataset.epoch_batches(batch_size, shuffle=shuffle, seed=seed,
                                     epoch=epoch, drop_last=drop_last)
    it = iterate_batches(dataset, batch_size, shuffle=shuffle, seed=seed,
                         epoch=epoch, drop_last=drop_last)
    return prefetch_to_device(it, device)


def first_batch(dataset, batch_size: int, device: torch.device, drop_last: bool = False):
    """The first unshuffled batch, for warm-up and latency calls outside the
    timed loops: from a store's gathers, or assembled on the calling thread
    (an abandoned prefetcher would strand its producer thread)."""
    if isinstance(dataset, (DeviceClipStore, ChunkedDeviceClipStore)):
        it = dataset.epoch_batches(batch_size, shuffle=False, seed=0, epoch=0,
                                   drop_last=drop_last)
        try:
            return next(iter(it))
        finally:
            it.close()
    return to_device(next(iter(iterate_batches(
        dataset, batch_size, shuffle=False, seed=0, epoch=0, drop_last=drop_last))), device)


def maybe_device_resident(cfg: dict, dataset, device: torch.device, log=print,
                          max_bytes: float = 4e9, batch_size: int | None = None):
    """Promote a ClipDataset to a store on ``device``.

    dataset.device_resident: auto (default) | true | false | chunked.
      auto: on a CUDA device, splits up to ``max_bytes`` go fully resident
        (DeviceClipStore) and larger ones rotate shards
        (ChunkedDeviceClipStore); on the CPU the host path stays.
      true: resident on any device; above 12 GB it warns and rotates shards.
      chunked: shard rotation (dataset.resident_shard_bytes caps a shard,
        default 2 GB; about two shards live at once).
    """
    if dataset is None:
        return None
    d_cfg = cfg.get("dataset", {})
    want = d_cfg.get("device_resident", "auto")
    if want in (False, 0, "false", "off"):
        return dataset
    est = len(dataset) * dataset.clip_len * dataset.image_size * dataset.image_size * 3

    def chunked():
        B = batch_size or int(cfg.get("training", cfg.get("runtime", {}))
                              .get("batch_size", 8))
        shard_bytes = float(d_cfg.get("resident_shard_bytes", 2e9))
        return ChunkedDeviceClipStore(dataset, shard_bytes, B, device, log=log)

    if want == "chunked":
        return chunked()
    if want == "auto":
        if device.type != "cuda":
            return dataset
        if est > max_bytes:
            return chunked()
    elif est > 12e9:
        log(f"[WARN] device_resident: split is {est / 1e9:.1f} GB; "
            "switching to chunked shard rotation")
        return chunked()
    return DeviceClipStore(dataset, device, log=log)


def make_logger(cfg: dict, name: str) -> Logger:
    log_dir = cfg.get("paths", {}).get("log_dir", "logs")
    ensure_dir(log_dir)
    return Logger(log_path=os.path.join(log_dir, f"{name}.log"))
