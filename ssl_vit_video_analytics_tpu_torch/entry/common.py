"""Shared runtime plumbing for the CLI entry points (the JAX package's
``entry/common.py`` on one device): config and device resolution, the
multi-device knobs resolved as JAX resolves them on one device, the
device-resident split and epoch batches."""
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


ONE_DEVICE = "the port runs on one device until ROADMAP item 15b"


def _data_parallel_request(cfg: dict) -> int:
    """``device.data_parallel`` as a device count: 1 for auto, true, false
    or unset (what one device resolves them to)."""
    want = cfg.get("device", {}).get("data_parallel", "auto")
    return 1 if isinstance(want, (bool, str)) or want is None else int(want)


def setup_data_parallel(cfg: dict, log=print) -> None:
    """The JAX entries' ``setup_data_parallel`` on one device: nothing to
    set up. JAX is silent there; an explicit ``device.data_parallel: N`` > 1
    logs one warning."""
    n = _data_parallel_request(cfg)
    if n > 1:
        log(f"[WARN] device.data_parallel={n} requested; {ONE_DEVICE}; ignoring")


def setup_parallelism(cfg: dict, log=print, allow_pp: bool = False) -> None:
    """The JAX entries' ``setup_parallelism`` (pipelines B and C) resolved
    on one device, with JAX's warnings where it logs one:
    ``device.expert_parallel`` and ``device.pipeline_parallel`` are ignored
    (``allow_pp``: the pipeline-B entry, which alone takes them),
    ``model.sequence_parallel`` falls back to the single-device attention
    kernel. Where JAX is silent on one device (``device.model_parallel``,
    ``device.data_parallel``), one warning names the knobs this ignores."""
    dev = cfg.get("device", {})
    sp_on = bool(cfg.get("model", {}).get("sequence_parallel", False)
                 or dev.get("sequence_parallel", False))
    tp = int(dev.get("model_parallel", 1) or 1)
    pp = int(dev.get("pipeline_parallel", 1) or 1)
    ep = int(dev.get("expert_parallel", 1) or 1)
    if ep > 1:
        if not allow_pp:
            log("[WARN] device.expert_parallel is only supported by the "
                "pipeline-B entry (train_ssl_mae); ignoring")
        elif sp_on or tp > 1 or pp > 1:
            log("[WARN] expert_parallel is exclusive with the other "
                "model-sharding knobs; ignoring expert_parallel")
        elif int(cfg.get("model", {}).get("decoder_moe_experts", 0) or 0) <= 0:
            log("[WARN] expert_parallel needs model.decoder_moe_experts > 0; ignoring")
        else:
            log("[WARN] expert_parallel requested on 1 device; ignoring")
    if pp > 1:
        if not allow_pp:
            log("[WARN] device.pipeline_parallel is only supported by the "
                "pipeline-B entry (train_ssl_mae); ignoring")
        elif sp_on or tp > 1:
            log("[WARN] pipeline_parallel is exclusive with sequence_parallel"
                "/model_parallel; ignoring pipeline_parallel")
        else:
            log("[WARN] pipeline_parallel requested on 1 device; ignoring")
    if sp_on:
        log("[WARN] sequence_parallel requested on 1 device; attention "
            "falls back to the single-device kernel")
    silent = {"device.model_parallel": tp, "device.data_parallel": _data_parallel_request(cfg)}
    asked = ", ".join(f"{knob}={n}" for knob, n in silent.items() if n > 1)
    if asked:
        log(f"[WARN] {asked} requested; {ONE_DEVICE}; ignoring")


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
