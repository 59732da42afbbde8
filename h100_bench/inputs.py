"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: weights, the split of clips, and the tube masks and
stochastic-depth decisions of the checked steps.

Weights are drawn on the device in one call and cut into the leaves of the
reference model's state dict (whose names the program's model shares):
conv and dense kernels N(0, 1/fan_in), position embeddings and mask token
N(0, 0.02^2), biases 0, norm scales 1, BatchNorm running mean 0 and
variance 1. Every norm scale is 1, also the last BatchNorm of a residual
block, so that every leaf takes part in the first step.

The split is a general generator of traffic: ``clips`` clips of
``clip_len`` frames, each a distinct window of one seeded pool of bytes,
served to the program through the duck type of its clip dataset, so that
the program's own store uploads it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

POOL_BYTES = 1 << 26  # the pool the clips are windows of


def stream_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for ``stream`` of a run's ``seed``."""
    return int(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream]).generate_state(
        1, np.uint64)[0]) >> 1


@torch.no_grad()
def make_weights(template: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """A full state dict for ``template`` (built on any device, ``meta``
    included) drawn from ``seed`` on ``device``."""
    norms = {name for name, m in template.named_modules()
             if isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm))}
    denses = {name for name, m in template.named_modules()
              if isinstance(m, (nn.Linear, nn.Conv2d))}
    sd = template.state_dict()
    drawn, total = [], 0
    for key, t in sd.items():
        owner, leaf = key.rpartition(".")[0], key.rpartition(".")[2]
        if owner in norms or leaf == "bias" or not t.is_floating_point():
            continue
        drawn.append(key)
        total += t.numel()
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    flat = torch.randn(total, generator=gen, device=device)
    out, lo = {}, 0
    for key, t in sd.items():
        owner, leaf = key.rpartition(".")[0], key.rpartition(".")[2]
        if key in drawn:
            w = flat[lo:lo + t.numel()].view(t.shape)
            lo += t.numel()
            scale = (1.0 / math.sqrt(math.prod(t.shape[1:]))) if owner in denses else 0.02
            out[key] = w.mul_(scale)
        elif leaf in ("weight", "running_var"):
            out[key] = torch.ones(t.shape, device=device)
        elif not t.is_floating_point():
            out[key] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        else:
            out[key] = torch.zeros(t.shape, device=device)
    return out


class SyntheticSplit:
    """A split of ``n`` clips ``[clip_len, size, size, 3]`` uint8, each a
    distinct window of a pool of random bytes drawn from the seed, with
    labels below ``num_classes`` where ``mode`` is not ``ssl``. Duck-types
    what the program's stores read of a clip dataset."""

    def __init__(self, n: int, clip_len: int, image_size: int, seed: int, mode: str,
                 num_classes: int = 0):
        self.mode, self.clip_len, self.image_size = mode, clip_len, image_size
        rng = np.random.default_rng(stream_seed(seed, 1))
        self.clip_bytes = clip_len * image_size * image_size * 3
        if self.clip_bytes > POOL_BYTES:
            raise ValueError(f"a clip of {self.clip_bytes} bytes exceeds the pool")
        self.pool = rng.integers(0, 256, POOL_BYTES, dtype=np.uint8)
        self.offsets = rng.choice(POOL_BYTES - self.clip_bytes + 1, size=n, replace=False)
        self.labels = rng.integers(0, max(num_classes, 1), size=n)

    def __len__(self) -> int:
        return len(self.offsets)

    def get_clip(self, index: int) -> np.ndarray:
        lo = int(self.offsets[index])
        return self.pool[lo:lo + self.clip_bytes].reshape(
            self.clip_len, self.image_size, self.image_size, 3)

    def label(self, index: int) -> int:
        return int(self.labels[index])


def tube_mask(gen: torch.Generator, B: int, T: int, L: int, ratio: float) -> torch.Tensor:
    """``[B, T, L]`` bool: ``int(ratio * L)`` patches of each clip, chosen
    uniformly, masked on every frame."""
    n = int(ratio * L)
    order = torch.rand(B, L, generator=gen, device=gen.device).argsort(-1)
    spatial = torch.zeros(B, L, dtype=torch.bool, device=gen.device)
    spatial.scatter_(1, order[:, :n], True)
    return spatial[:, None].expand(B, T, L)


def keep_factors(gen: torch.Generator, rates: list[list[float]], frames: int,
                 pairs_from: int = 1) -> list[list]:
    """Stochastic-depth decisions for ``frames`` samples: per stage, per
    block, None at rate 0, else ``kept / (1 - rate)`` per sample; from
    stage ``pairs_from`` on, a pair (one per residual branch)."""

    def draw(rate):
        kept = torch.rand(frames, generator=gen, device=gen.device) < 1.0 - rate
        return kept.float() / (1.0 - rate)

    out = []
    for i, stage in enumerate(rates):
        row = []
        for rate in stage:
            if not rate:
                row.append(None)
            elif i >= pairs_from:
                row.append((draw(rate), draw(rate)))
            else:
                row.append(draw(rate))
        out.append(row)
    return out
