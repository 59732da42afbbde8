"""Device-resident clip store: the split lives in device memory and a batch
is a gather on the device (counterpart of the JAX package's
``data/device_store.py``).

A 3k-clip 112x112 T=16 uint8 split is about 1.8 GB, a small part of the
card's 80 GB: uploaded once, every batch is an ``index_select`` on the
device, and the only recurring host-to-device traffic is a ``[B]`` index
vector. Labels live on the device too.

Batch composition (epoch order, tail padding, ``valid`` masks) reuses
``loader.iter_batch_indices`` and ``loader._epoch_order``, so batches are
bit-identical to the host path: ``get_clip`` is deterministic per (seed,
index), so materializing the split up front is exact.

Under a ``data`` or ``seq`` mesh every rank holds the whole split, as the
JAX package replicates it over the mesh, and walks the same epoch order;
``epoch_batches(..., mesh=)`` gathers only this rank's rows, or its frames
of every clip, on its own card.

A batch's gather is a ``store.gather`` span (``utils/tracing.py``).
"""
from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from ..utils import tracing
from .loader import ClipDataset, _epoch_order, iter_batch_indices


def _index(idxs: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(idxs.astype(np.int64)).to(device)


def _labels(dataset: ClipDataset, device: torch.device) -> torch.Tensor | None:
    """The split's labels as int32 on ``device`` (the host path's dtype), or
    None for an ``ssl`` split."""
    if dataset.mode == "ssl":
        return None
    return torch.tensor([dataset.label(i) for i in range(len(dataset))],
                        dtype=torch.int32, device=device)


def _part(mesh, batch_size: int, clip_len: int) -> tuple[slice, slice]:
    """The rows and frames of a global batch that this rank gathers."""
    if mesh is None:
        return slice(None), slice(None)
    return mesh.batch_part(batch_size, clip_len)


def _frames(clips: torch.Tensor, frames: slice) -> torch.Tensor:
    """``clips [B, T, ...]`` cut to ``frames`` (a copy, contiguous), or as
    they are when whole."""
    if frames == slice(None):
        return clips
    return clips[:, frames].contiguous()


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(host)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceClipStore:
    """The whole split on ``device``. Duck-types what the entry points use of
    ``ClipDataset`` (``len``, ``mode``, ``clip_len``, ``image_size``) and
    provides ``epoch_batches``."""

    def __init__(self, dataset: ClipDataset, device: torch.device | str, log=print):
        self.device = torch.device(device)
        self.mode = dataset.mode
        self.clip_len = dataset.clip_len
        self.image_size = dataset.image_size
        clips = np.stack([dataset.get_clip(i) for i in range(len(dataset))])
        self.clips = _upload(clips, self.device)
        self.labels = _labels(dataset, self.device)
        log(f"[INFO] device-resident store: {len(dataset)} clips "
            f"({clips.nbytes / 1e9:.2f} GB) uploaded once to {self.device}")

    def __len__(self) -> int:
        return self.clips.shape[0]

    def epoch_batches(self, batch_size: int, *, shuffle: bool, seed: int,
                      epoch: int, drop_last: bool = True, mesh=None):
        rows, frames = _part(mesh, batch_size, self.clip_len)
        for idxs_full, valid in iter_batch_indices(
                len(self), batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                drop_last=drop_last):
            with tracing.span("store.gather"):
                idx = _index(idxs_full[rows], self.device)
                batch = {"clip": _frames(self.clips.index_select(0, idx), frames),
                         "valid": torch.from_numpy(valid[rows]).to(self.device)}
                if self.labels is not None:
                    batch["label"] = self.labels.index_select(0, idx)
            yield batch


class ChunkedDeviceClipStore:
    """Rotating device-resident shards for splits larger than the device
    budget.

    Exactness: each epoch's permutation is the host path's own
    ``_epoch_order(n, shuffle, seed, epoch)``, cut into contiguous shards of
    ``clips_per_shard`` (a multiple of the batch size, so a batch never spans
    two shards). Batch order, composition, tail padding and ``valid`` masks
    are therefore bit-identical to ``iter_batch_indices``.

    Pipelining: while shard k trains, a host thread assembles shard k+1 and
    uploads it from pinned memory on a side stream; the consuming stream
    waits for that upload's event before its first gather. The shard is
    marked as used by the consuming stream (``record_stream``), so when it
    is freed after its last gather the allocator does not hand its memory to
    the next upload before those gathers have run. At most two shards are on
    the device at once.
    """

    def __init__(self, dataset: ClipDataset, shard_bytes: float, batch_size: int,
                 device: torch.device | str, log=print):
        self.ds = dataset
        self.device = torch.device(device)
        self.mode = dataset.mode
        self.clip_len = dataset.clip_len
        self.image_size = dataset.image_size
        n = len(dataset)
        clip_bytes = dataset.clip_len * dataset.image_size ** 2 * 3
        per = max(int(shard_bytes) // clip_bytes, batch_size)
        per -= per % batch_size  # batches never span shards
        self.clips_per_shard = min(per, n)
        self.batch_size = batch_size
        self.n = n
        self.num_shards = (n + self.clips_per_shard - 1) // self.clips_per_shard
        self.labels = _labels(dataset, self.device)
        log(f"[INFO] chunked device store: {n} clips in {self.num_shards} "
            f"shards of <= {self.clips_per_shard} "
            f"({self.clips_per_shard * clip_bytes / 1e9:.2f} GB resident x2) on {self.device}")

    def __len__(self) -> int:
        return self.n

    def _assemble(self, global_idxs: np.ndarray, stream):
        """One shard: assembled on the host, uploaded on ``stream`` (CUDA).
        Returns the device tensor and the event its upload records."""
        host = np.stack([self.ds.get_clip(int(i)) for i in global_idxs])
        if stream is None:
            return _upload(host, self.device), None
        with torch.cuda.stream(stream):
            shard = _upload(host, self.device)
            done = torch.cuda.Event()
            done.record(stream)
        return shard, done

    def epoch_batches(self, batch_size: int, *, shuffle: bool, seed: int,
                      epoch: int, drop_last: bool = True, mesh=None):
        rows, frames = _part(mesh, batch_size, self.clip_len)
        if batch_size != self.batch_size:
            raise ValueError(f"ChunkedDeviceClipStore is sized for batch_size="
                             f"{self.batch_size}, not {batch_size}")
        C = self.clips_per_shard
        order = _epoch_order(self.n, shuffle, seed, epoch)
        shards = [order[lo:lo + C] for lo in range(0, self.n, C)]
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        pool = cf.ThreadPoolExecutor(max_workers=1)
        try:
            nxt = pool.submit(self._assemble, shards[0], side)
            for si, shard in enumerate(shards):
                arr, done = nxt.result()
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    arr.record_stream(consumer)
                if si + 1 < len(shards):
                    nxt = pool.submit(self._assemble, shards[si + 1], side)
                for lo in range(0, len(shard), batch_size):
                    sel = shard[lo:lo + batch_size]  # global indices
                    local = np.arange(lo, lo + len(sel))
                    if len(sel) < batch_size:  # global tail (last shard only)
                        if drop_last:
                            break
                        # as iter_batch_indices: pad with the last index, mask
                        # the pads out
                        n_real = len(sel)
                        local = np.concatenate([local, np.full(batch_size - n_real, local[-1])])
                        sel = np.concatenate([sel, np.full(batch_size - n_real, sel[-1])])
                        valid = np.zeros(batch_size, bool)
                        valid[:n_real] = True
                    else:
                        valid = np.ones(batch_size, bool)
                    local, sel, valid = local[rows], sel[rows], valid[rows]
                    with tracing.span("store.gather"):
                        clips = arr.index_select(0, _index(local, self.device))
                        batch = {"clip": _frames(clips, frames),
                                 "valid": torch.from_numpy(valid).to(self.device)}
                        if self.labels is not None:
                            batch["label"] = self.labels.index_select(0, _index(sel, self.device))
                    yield batch
                del arr  # freed once the gathers queued on it have run
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
