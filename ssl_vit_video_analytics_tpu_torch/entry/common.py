"""Shared runtime plumbing for the CLI entry points (the JAX package's
``entry/common.py``): config and device resolution, the launcher's process
group and the multi-device knobs resolved as JAX resolves them over its
devices (``data``, ``seq``, ``data`` x ``expert``, ``pipe`` and ``data`` x
``model`` meshes), the device-resident split and each rank's part of the
epoch's batches."""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..data.device_store import ChunkedDeviceClipStore, DeviceClipStore
from ..data.loader import ClipDataset, iterate_batches, prefetch_to_device, to_device
from ..ops import attention
from ..parallel import mesh as pmesh
from ..parallel.ep import count_bank_sharded
from ..parallel.shard import shard_model
from ..parallel.tp import count_sharded
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
    under a launcher a bare ``cuda`` is this process's card,
    ``cuda:LOCAL_RANK``. Raises for cuda when no card is there."""
    device = torch.device(device or cfg.get("device", {}).get("name", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    if device.type == "cuda" and device.index is None and pmesh.launched():
        device = torch.device("cuda", pmesh.local_rank())
    return device


def init_distributed(cfg: dict, device: str | torch.device | None = None,
                     log=print) -> torch.device:
    """The device of :func:`device_from`, with the launcher's process group
    joined on it (NCCL on a card, gloo on the CPU; one log line) when
    ``torchrun`` started this process; without a launcher, the device
    alone."""
    device = device_from(cfg, device)
    if pmesh.init_distributed(device):
        log(f"[INFO] process group: {dist.get_backend()}, rank {pmesh.rank()} of "
            f"{pmesh.world_size()} on {device}")
    return device


ONE_DEVICE = ("one process runs on one device; launch one process a card with "
              "torchrun --nproc_per_node N for several")
# the port's words where JAX's TP line says "(attention impl -> xla)": the
# port keeps its kernels under TP, on whole heads (parallel/tp.py)
TP_ATTENTION = "(attention: K1/K2 on each rank's whole heads)"


class ParallelRuntime(NamedTuple):
    """What :func:`setup_parallelism` resolved: the mesh (None on one
    device), whether the decoder's attention is sequence parallel
    (``sp_on``, also set when it falls back on one device, as JAX's), and
    under pipeline parallelism the ``pipe`` mesh again as ``pp_mesh`` with
    its microbatch count (JAX's fields)."""

    mesh: pmesh.Mesh | None
    sp_on: bool = False
    pp_mesh: pmesh.Mesh | None = None
    pp_microbatches: int | None = None

    @property
    def member(self) -> bool:
        """Whether this rank takes part (every rank on one device)."""
        return self.mesh is None or self.mesh.member


class Resolution(NamedTuple):
    """What :func:`resolve_parallelism` picks: the mesh's ``{axis: size}``
    (None: one device), ``sp_on``, and the pipeline's microbatches."""

    axes: dict | None
    sp_on: bool = False
    pp_microbatches: int | None = None


def _data_parallel_request(cfg: dict) -> int:
    """``device.data_parallel`` as a device count: 1 for auto, true, false
    or unset (what one device resolves them to)."""
    want = cfg.get("device", {}).get("data_parallel", "auto")
    return 1 if isinstance(want, (bool, str)) or want is None else int(want)


def _warn_one_device(cfg: dict, tp: int, log) -> None:
    """One device: the knobs on which JAX is silent there, in one line."""
    silent = {"device.model_parallel": tp, "device.data_parallel": _data_parallel_request(cfg)}
    asked = ", ".join(f"{knob}={n}" for knob, n in silent.items() if n > 1)
    if asked:
        log(f"[WARN] {asked} requested; {ONE_DEVICE}; ignoring")


def resolve_data_parallel(cfg: dict, batch_size: int, world: int, log=print) -> int:
    """The ``data`` axis size that the JAX entries' ``setup_data_parallel``
    picks over ``world`` devices (1: off), with its log lines.

    ``device.data_parallel``: auto (default; on with more than one rank) |
    false | N (N ranks). As in JAX, ``want in (False, 0, 1)`` turns it off,
    which catches ``true`` too (``True == 1``). n shrinks until it divides
    ``batch_size``. One device logs one warning for an explicit N > 1 where
    JAX is silent."""
    want = cfg.get("device", {}).get("data_parallel", "auto")
    if world == 1:
        n = _data_parallel_request(cfg)
        if n > 1:
            log(f"[WARN] device.data_parallel={n} requested; {ONE_DEVICE}; ignoring")
        return 1
    if want in (False, 0, 1):
        return 1
    n = world if want == "auto" else min(int(want), world)
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n <= 1:
        log(f"[WARN] batch_size={batch_size} not divisible across {world} devices; "
            "running single-device")
        return 1
    log(f"[INFO] data-parallel over {n} devices: {pmesh.mesh_repr({'data': n})}")
    return n


def _expert_mesh(cfg: dict, ep: int, moe: int, batch_size: int, world: int, log) -> dict:
    """JAX's ``data`` x ``expert`` mesh: ep shrinks until it divides the
    experts; the ranks left form the data axis, capped by an explicit
    ``device.data_parallel`` (``is True``, not ``== 1``: an explicit 1
    turns it off) and shrunk until it divides the batch."""
    ep = min(ep, world)
    while ep > 1 and moe % ep:
        ep -= 1
    dp_req = cfg.get("device", {}).get("data_parallel", "auto")
    dp = (world // ep if (dp_req == "auto" or dp_req is True or dp_req is None)
          else int(dp_req or 1))
    dp = max(1, min(dp, world // ep))
    while dp > 1 and batch_size % dp:
        dp -= 1
    axes = {"data": dp, "expert": ep}
    log(f"[INFO] expert-parallel MoE decoder: {moe} experts over {ep} devices"
        + (f" x dp{dp}" if dp > 1 else "") + f": {pmesh.mesh_repr(axes)}")
    return axes


def resolve_parallelism(cfg: dict, batch_size: int, world: int, log=print,
                        allow_pp: bool = False) -> Resolution:
    """The mesh that the JAX entries' ``setup_parallelism`` (pipelines B
    and C) builds over ``world`` devices, with its log lines, in its order
    of precedence:

    - ``device.expert_parallel`` (the pipeline-B entry alone, ``allow_pp``;
      exclusive with the other model-sharding knobs; needs
      ``model.decoder_moe_experts``): ``{"data": dp, "expert": ep}``.
    - ``device.pipeline_parallel`` (pipeline B alone): ``{"pipe": pp}``
      with ``device.pp_microbatches`` (default pp) microbatches, which must
      divide the batch (JAX's ``ValueError``).
    - ``model.sequence_parallel`` (or ``device.sequence_parallel``): a
      ``seq`` axis over every rank; on one device the single-device kernel
      with JAX's warning (``sp_on`` stays set, as JAX's).
    - ``device.model_parallel``: ``{"data": dp, "model": tp}``, tp shrunk
      until it divides the ranks, dp the rest shrunk until it divides the
      batch.
    - else :func:`resolve_data_parallel`.

    Where JAX warns and ignores a knob, so does the port. On one device,
    where JAX is silent on ``device.model_parallel`` and an explicit
    ``device.data_parallel: N``, one warning names them."""
    dev = cfg.get("device", {})
    sp_on = bool(cfg.get("model", {}).get("sequence_parallel", False)
                 or dev.get("sequence_parallel", False))
    tp = int(dev.get("model_parallel", 1) or 1)
    pp = int(dev.get("pipeline_parallel", 1) or 1)
    ep = int(dev.get("expert_parallel", 1) or 1)
    if ep > 1:
        moe = int(cfg.get("model", {}).get("decoder_moe_experts", 0) or 0)
        if not allow_pp:
            log("[WARN] device.expert_parallel is only supported by the "
                "pipeline-B entry (train_ssl_mae); ignoring")
        elif sp_on or tp > 1 or pp > 1:
            log("[WARN] expert_parallel is exclusive with the other "
                "model-sharding knobs; ignoring expert_parallel")
        elif moe <= 0:
            log("[WARN] expert_parallel needs model.decoder_moe_experts > 0; ignoring")
        elif world < 2:
            log("[WARN] expert_parallel requested on 1 device; ignoring")
        else:
            return Resolution(_expert_mesh(cfg, ep, moe, batch_size, world, log))
    if pp > 1:
        if not allow_pp:
            log("[WARN] device.pipeline_parallel is only supported by the "
                "pipeline-B entry (train_ssl_mae); ignoring")
        elif sp_on or tp > 1:
            log("[WARN] pipeline_parallel is exclusive with sequence_parallel"
                "/model_parallel; ignoring pipeline_parallel")
        elif world < 2:
            log("[WARN] pipeline_parallel requested on 1 device; ignoring")
        else:
            pp = min(pp, world)
            axes = {"pipe": pp}
            n_micro = int(dev.get("pp_microbatches", pp) or pp)
            if batch_size % n_micro:
                raise ValueError(f"batch_size={batch_size} not divisible by "
                                 f"pp_microbatches={n_micro}")
            log(f"[INFO] pipeline-parallel decoder over {pp} stages, "
                f"{n_micro} microbatches: {pmesh.mesh_repr(axes)}")
            return Resolution(axes, False, n_micro)
    if sp_on:
        if world == 1:
            log("[WARN] sequence_parallel requested on 1 device; attention "
                "falls back to the single-device kernel")
            _warn_one_device(cfg, tp, log)
            return Resolution(None, True)
        axes = {"seq": world}
        log(f"[INFO] sequence-parallel over {world} devices: {pmesh.mesh_repr(axes)}")
        return Resolution(axes, True)
    if tp > 1 and world > 1:
        tp = min(tp, world)
        while tp > 1 and world % tp:
            tp -= 1
        dp = world // tp
        while dp > 1 and batch_size % dp:
            dp -= 1
        axes = {"data": dp, "model": tp}
        log(f"[INFO] dp{dp} x tp{tp} mesh: {pmesh.mesh_repr(axes)} {TP_ATTENTION}")
        return Resolution(axes)
    if world == 1:
        _warn_one_device(cfg, tp, log)
        return Resolution(None)
    n = resolve_data_parallel(cfg, batch_size, world, log)
    return Resolution({"data": n} if n > 1 else None)


def _mesh(axes: dict) -> pmesh.Mesh:
    """The mesh of the first ranks; a rank outside it prints one line
    (rank 0 is in every mesh, and the other ranks' loggers are silent)."""
    mesh = pmesh.make_mesh(axes)
    if not mesh.member:
        print(f"[INFO] rank {pmesh.rank()} is outside the mesh {mesh!r}; it takes no part",
              flush=True)
    return mesh


def setup_data_parallel(cfg: dict, batch_size: int, log=print) -> pmesh.Mesh | None:
    """The ``data`` mesh over the launcher's ranks that
    :func:`resolve_data_parallel` picks (pipeline A, the finetune), or None
    on one device."""
    n = resolve_data_parallel(cfg, batch_size, pmesh.world_size(), log)
    return _mesh({"data": n}) if n > 1 else None


def setup_parallelism(cfg: dict, batch_size: int, log=print,
                      allow_pp: bool = False) -> ParallelRuntime:
    """The runtime of :func:`resolve_parallelism` over the launcher's
    ranks: its mesh, under ``seq`` the group registered for the decoder's
    ``"sp"`` attention (``ops/attention.set_sp_group``), and under ``pipe``
    the pipeline's mesh and microbatches. The model is cut over the mesh
    by the entry (:func:`place_model`)."""
    res = resolve_parallelism(cfg, batch_size, pmesh.world_size(), log, allow_pp)
    mesh = _mesh(res.axes) if res.axes is not None else None
    if res.sp_on:
        attention.set_sp_group(None if mesh is None or not mesh.member else mesh.group())
    if res.pp_microbatches is not None:
        return ParallelRuntime(mesh, False, mesh, res.pp_microbatches)
    return ParallelRuntime(mesh, res.sp_on)


def place_model(model: torch.nn.Module, mesh: pmesh.Mesh | None, log=print) -> None:
    """JAX's ``place_state``: the replicas made identical (from the mesh's
    first rank), then cut over the mesh's model axis, with JAX's log line
    of the leaves cut (``EP: n/N param leaves (expert banks) sharded over
    'expert'``, ``TP: n/N param leaves sharded over 'model'``)."""
    pmesh.broadcast_module(model, mesh)
    axis = None if mesh is None else mesh.model_axis
    shard_model(model, mesh)
    if axis == "expert":
        n_sh, n_tot = count_bank_sharded(model)
        log(f"[INFO] EP: {n_sh}/{n_tot} param leaves (expert banks) sharded over 'expert'")
    elif axis == "model":
        n_sh, n_tot = count_sharded(model)
        log(f"[INFO] TP: {n_sh}/{n_tot} param leaves sharded over 'model'")


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
                  device: torch.device, drop_last: bool = True, mesh=None):
    """One epoch's batches on ``device``: gathers from a device-resident
    store, or the host path with its background prefetch. With a ``data``
    or ``seq`` ``mesh`` each is this rank's rows or frames of the global
    batch of ``batch_size`` clips."""
    if isinstance(dataset, (DeviceClipStore, ChunkedDeviceClipStore)):
        return dataset.epoch_batches(batch_size, shuffle=shuffle, seed=seed,
                                     epoch=epoch, drop_last=drop_last, mesh=mesh)
    it = iterate_batches(dataset, batch_size, shuffle=shuffle, seed=seed,
                         epoch=epoch, drop_last=drop_last, mesh=mesh)
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
    """The entry's log file and stdout on rank 0 (or without a launcher);
    a silent logger on the other ranks: rank 0 alone writes logs."""
    if not pmesh.is_main():
        return Logger(log_path=None, echo=False)
    log_dir = cfg.get("paths", {}).get("log_dir", "logs")
    ensure_dir(log_dir)
    return Logger(log_path=os.path.join(log_dir, f"{name}.log"))
