"""Clip dataset + batched iteration with device prefetch (counterpart of
the JAX package's ``data/loader.py``; sampling and batch composition are
copied unchanged, so batches are bit-identical to the JAX host path).

Sampling semantics match the reference's ``LazyFrameDataset`` exactly
(ref: src/datasets/loader.py:21-117):

- per-sample deterministic RNG ``random.Random(seed + index)`` chooses the
  clip start offset (so val sampling is reproducible across frameworks),
- strided indices ``start + i*stride`` clamped to the last frame,
- ``ssl`` mode yields clips only; ``supervised`` yields (clip, label).

Batches are assembled host-side as channel-last uint8 ``[B, T, H, W, 3]``
numpy arrays; ``prefetch_to_device`` copies them to the device from pinned
memory on a background thread, and normalization happens on the device.
"""
from __future__ import annotations

import random
import threading
import queue as queue_mod
from typing import Iterator

import numpy as np
import torch

from .frames import make_store
from .splits import read_split


def sample_frame_indices(num_frames: int, index: int, clip_len: int, stride: int, seed: int) -> list[int]:
    """Deterministic-but-diverse clip start (ref: src/datasets/loader.py:65-76)."""
    rng = random.Random(seed + index)
    max_start = max(0, num_frames - clip_len * stride)
    start = rng.randint(0, max_start) if max_start > 0 else 0
    return [min(start + i * stride, num_frames - 1) for i in range(clip_len)]


def sample_frame_indices_mae(num_frames: int, index: int, clip_len: int, stride: int,
                             seed: int) -> list[int]:
    """Pipeline-B sampling: linspace over short videos, random strided window
    otherwise (ref: src/datasets/mae_loader.py:48-59; deterministic per-index
    RNG instead of global np.random so val sampling is reproducible)."""
    rng = random.Random(seed + index)
    window = clip_len * stride
    if num_frames < window:
        if clip_len == 1:
            return [0]
        step = (num_frames - 1) / (clip_len - 1)
        return [min(int(round(i * step)), num_frames - 1) for i in range(clip_len)]
    start = rng.randint(0, num_frames - window)
    return list(range(start, start + window, stride))[:clip_len]


class ClipDataset:
    """Lazy frame-folder clip dataset.

    Yields uint8 RGB clips [T, H, W, 3]; labels as python ints.
    """

    def __init__(
        self,
        split_file: str,
        mode: str = "ssl",
        clip_len: int = 16,
        stride: int = 2,
        image_size: int = 112,
        seed: int = 42,
        backend: str = "packed",
        sampling: str = "strided",  # strided (ref loader) | mae (linspace fallback)
        verbose: bool = True,
    ):
        self.samples = read_split(split_file)
        self.mode = mode
        self.clip_len = clip_len
        self.stride = stride
        self.image_size = image_size
        self.seed = seed
        self.sampling = sampling
        self.store = make_store(backend, image_size)
        if verbose:
            print(f"[INFO] Loaded {len(self.samples)} samples from {split_file}")
            print(f"[INFO] Dataset mode: {self.mode}")
            print(f"[INFO] Clip length: {self.clip_len}, Stride: {self.stride}")

    def __len__(self) -> int:
        return len(self.samples)

    def get_clip(self, index: int) -> np.ndarray:
        # Corrupt-sample fallback: random resample, like the reference
        # (ref: src/datasets/loader.py:109-112) — but BOUNDED: with an
        # unreadable dataset (e.g. wrong image_size -> no packed file and no
        # jpegs anywhere) unbounded resampling recursed to a RecursionError.
        for _ in range(16):
            frame_dir, _ = self.samples[index]
            num_frames = self.store.num_frames(frame_dir)
            if num_frames > 0:
                sampler = (sample_frame_indices_mae if self.sampling == "mae"
                           else sample_frame_indices)
                idxs = sampler(num_frames, index, self.clip_len, self.stride, self.seed)
                return self.store.read_frames(frame_dir, idxs, self.image_size)
            index = random.randint(0, len(self.samples) - 1)
        raise RuntimeError(
            f"[ERROR] 16 consecutive unreadable videos (last: {frame_dir}) — "
            f"is dataset.image_size={self.image_size} right for this frame tree?")

    def label(self, index: int) -> int:
        return self.samples[index][1]


def _epoch_order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    rng = np.random.default_rng(seed + epoch)
    return rng.permutation(n)


def iterate_batches(
    dataset: ClipDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 42,
    epoch: int = 0,
    drop_last: bool = True,
    mesh=None,
) -> Iterator[dict]:
    """Yield {"clip": uint8 [B,T,H,W,3], "label": int32 [B]} numpy batches.

    drop_last=True keeps every device batch the same shape; the ragged tail is instead padded when drop_last=False, with
    a boolean "valid" mask so eval metrics stay exact. With a ``mesh``
    (``parallel/mesh.Mesh``) each batch is this rank's part of the global
    one: its rows (``data``; only those clips are read) or its frames of
    every clip (``seq``).
    """
    n = len(dataset)
    if drop_last and n < batch_size:
        # Silently yielding nothing makes "training" a no-op every epoch —
        # an easy footgun with batch_size > tiny dataset. Loud, not fatal
        # (the reference's torch DataLoader is silently empty here too).
        print(f"[WARN] iterate_batches: dataset size {n} < batch_size "
              f"{batch_size} with drop_last=True -> ZERO batches per epoch")
    for idxs_full, valid in iter_batch_indices(n, batch_size, shuffle=shuffle,
                                               seed=seed, epoch=epoch,
                                               drop_last=drop_last):
        if mesh is not None:
            rows, frames = mesh.batch_part(batch_size, dataset.clip_len)
            idxs_full, valid = idxs_full[rows], valid[rows]
        clips = np.stack([dataset.get_clip(int(i)) for i in idxs_full])
        if mesh is not None:
            clips = np.ascontiguousarray(clips[:, frames])
        batch = {"clip": clips, "valid": valid}
        if dataset.mode != "ssl":
            batch["label"] = np.array([dataset.label(int(i)) for i in idxs_full], dtype=np.int32)
        yield batch


def iter_batch_indices(n: int, batch_size: int, *, shuffle: bool, seed: int,
                       epoch: int, drop_last: bool) -> Iterator[tuple]:
    """The batch-composition logic of :func:`iterate_batches` (epoch order,
    tail pad-with-last + valid mask) factored out so the host path and the
    device-resident path (the JAX package's ``DeviceClipStore``) are
    bit-identical."""
    order = _epoch_order(n, shuffle, seed, epoch)
    B = batch_size
    for lo in range(0, n, B):
        idxs = order[lo:lo + B]
        if len(idxs) < B:
            if drop_last:
                return
            pad = np.concatenate([idxs, np.full(B - len(idxs), idxs[-1])])
            valid = np.zeros(B, dtype=bool)
            valid[: len(idxs)] = True
            idxs_full = pad
        else:
            valid = np.ones(B, dtype=bool)
            idxs_full = idxs
        yield idxs_full, valid


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``; CUDA copies go from pinned host
    memory with ``non_blocking`` (ordered on the current stream)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def prefetch_to_device(it: Iterator[dict], device: torch.device | str,
                       size: int = 2) -> Iterator[dict]:
    """Move batches to ``device`` ahead of consumption on a background thread,
    so host assembly overlaps device compute."""
    device = torch.device(device)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    _END = object()

    def producer():
        try:
            for batch in it:
                q.put(to_device(batch, device))
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
            # A swallowed producer error would silently truncate the epoch;
            # surface it in the consuming thread instead.
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
