"""Shared runtime plumbing for the CLI entry points (the single-device parts
of the JAX package's ``entry/common.py``; multi-device setup comes with the
multi-GPU item of ROADMAP queue 1)."""
from __future__ import annotations

import argparse
import os

import torch

from ..data.loader import ClipDataset, iterate_batches, prefetch_to_device
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
    """``device`` if given, else ``device.name`` of the config, else cuda."""
    return torch.device(device or cfg.get("device", {}).get("name", "cuda"))


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
    it = iterate_batches(dataset, batch_size, shuffle=shuffle, seed=seed,
                         epoch=epoch, drop_last=drop_last)
    return prefetch_to_device(it, device)


def make_logger(cfg: dict, name: str) -> Logger:
    log_dir = cfg.get("paths", {}).get("log_dir", "logs")
    ensure_dir(log_dir)
    return Logger(log_path=os.path.join(log_dir, f"{name}.log"))
