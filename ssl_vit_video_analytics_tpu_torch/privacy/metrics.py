"""Privacy metrics (counterpart of the JAX package's ``privacy/metrics.py``;
ref: src/privacy/metrics_privacy.py)."""
from __future__ import annotations

import torch

from ..utils.metrics import privacy_exposure_rate  # noqa: F401  (re-exported)


def prediction_entropy(logits: torch.Tensor) -> float:
    """Mean softmax entropy with the reference's ``log(p + 1e-12)``
    (ref: src/privacy/metrics_privacy.py:5-8)."""
    prob = torch.softmax(logits.float(), dim=1)
    return float((-(prob * torch.log(prob + 1e-12)).sum(dim=1)).mean())


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    return float((logits.argmax(dim=1) == labels.long()).float().mean())
