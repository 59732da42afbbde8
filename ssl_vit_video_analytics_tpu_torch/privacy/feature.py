"""Feature-level privacy: Gaussian perturbation and Bernoulli feature masking
(counterpart of the JAX package's ``privacy/feature.py``).

z' = z + N(0, sigma^2 I) and z' = z * Bernoulli(1 - r)
(ref: src/privacy/feature_noise.py:4-15), drawn from an explicit
``torch.Generator`` on the embeddings' device in place of a PRNG key. The
draws differ from ``jax.random``'s; their laws are the same.
"""
from __future__ import annotations

import torch


def add_gaussian_noise(generator: torch.Generator, z: torch.Tensor,
                       sigma: float) -> torch.Tensor:
    """``z`` itself for ``sigma <= 0``."""
    if sigma <= 0:
        return z
    return z + torch.randn(z.shape, generator=generator, device=z.device,
                           dtype=z.dtype) * sigma


def apply_feature_mask(generator: torch.Generator, z: torch.Tensor,
                       mask_ratio: float) -> torch.Tensor:
    """Each entry kept with probability ``1 - mask_ratio``, else zeroed;
    ``z`` itself for ``mask_ratio <= 0``."""
    if mask_ratio <= 0:
        return z
    keep = torch.rand(z.shape, generator=generator, device=z.device) < 1.0 - mask_ratio
    return z * keep.to(z.dtype)


def perturb_features(generator: torch.Generator, z: torch.Tensor, sigma: float,
                     mask_ratio: float) -> torch.Tensor:
    """Noise then mask, the composition run_privacy sweeps over a grid
    (ref: src/run_privacy.py:286-300)."""
    return apply_feature_mask(generator, add_gaussian_noise(generator, z, sigma), mask_ratio)
