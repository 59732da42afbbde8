"""Randomness policy (counterpart of the JAX package's ``utils/prng.py``).

Host-side randomness that must match the reference bit-for-bit (split files,
per-sample frame offsets) uses Python's ``random.Random`` with the
reference's seeding scheme. Device-side randomness (init, dropout, random
frame scores) draws from ``torch.Generator``s passed explicitly. They give
other numbers than ``jax.random`` from the same seed.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed the host RNGs and torch's global RNG; return a CPU generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)



def step_generator(seed: int, step: int, device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` alone (the
    counterpart of ``jax.random.fold_in(base, step)``): a run resumed at
    ``step`` draws what an uninterrupted run drew there."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))
