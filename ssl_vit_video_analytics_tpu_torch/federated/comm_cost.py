"""Communication accounting (counterpart of the JAX package's
``federated/comm_cost.py``): the reference's formulas, so fed_summary.csv
stays comparable (ref: src/federated/comm_cost.py:4-26)."""
from __future__ import annotations

from typing import Mapping

import torch


def model_size_bytes(state: Mapping[str, torch.Tensor]) -> int:
    """Total bytes of the tensors of a ``state_dict``: the params and the
    BatchNorm running mean and variance, what the JAX package counts over its
    ``params`` and ``batch_stats``. torch's ``num_batches_tracked`` has no
    flax leaf and is left out, so ``model_mb`` equals the reference's."""
    return int(sum(t.numel() * t.element_size() for k, t in state.items()
                   if not k.endswith("num_batches_tracked")))


def bytes_to_mb(x: int | float) -> float:
    return float(x) / (1024.0 * 1024.0)


def estimate_comm_mb_per_round(state: Mapping[str, torch.Tensor],
                               num_clients_participating: int) -> tuple[float, float]:
    """FedAvg per-round traffic: broadcast + upload = 2 * N * model_size.

    Returns (total_mb, model_mb).
    """
    size_b = model_size_bytes(state)
    total_b = int(2 * int(num_clients_participating) * size_b)
    return bytes_to_mb(total_b), bytes_to_mb(size_b)


def estimate_raw_upload_mb(num_samples: int, clip_len: int, image_size: int,
                           channels: int = 3, bytes_per_value: int = 1) -> float:
    """Centralized counterfactual: uploading raw uint8 clips
    (ref: src/run_federated.py:183-206)."""
    total = num_samples * channels * clip_len * image_size * image_size * bytes_per_value
    return bytes_to_mb(total)
