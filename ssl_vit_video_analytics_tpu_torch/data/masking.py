"""Token masks for MAE-style SSL (the pipeline-B part of the JAX package's
``data/masking.py``).

Every mask is drawn on the device from an explicit ``torch.Generator``: draw
per-token uniform noise, mask the ``num_mask`` largest. That is the JAX
package's selection; the numbers differ from ``jax.random``'s, so tests
inject the JAX mask where values matter.

Convention: ``True = masked`` (same as the reference).
"""
from __future__ import annotations

import torch


def _topk_mask(generator: torch.Generator, batch: int, n: int, num_mask: int,
               device: torch.device | None = None) -> torch.Tensor:
    """``[batch, n]`` bool with exactly ``num_mask`` True per row, uniformly
    at random."""
    noise = torch.rand(batch, n, generator=generator, device=generator.device)
    order = torch.argsort(noise, dim=-1, descending=True)
    ranks = torch.argsort(order, dim=-1)
    return (ranks < num_mask).to(device or generator.device)


def get_tube_mask(generator: torch.Generator, batch_size: int, num_frames: int,
                  num_patches: int, mask_ratio: float,
                  device: torch.device | None = None) -> torch.Tensor:
    """``[B, T, L]`` bool tube mask with ``int(ratio*L)`` masked patches per
    sample, the same patches on every frame (pipeline-B semantics, ref:
    src/datasets/mae_loader.py:80-90: floor, not round)."""
    num_mask = int(mask_ratio * num_patches)
    spatial = _topk_mask(generator, batch_size, num_patches, num_mask, device)
    return spatial[:, None, :].expand(batch_size, num_frames, num_patches)
