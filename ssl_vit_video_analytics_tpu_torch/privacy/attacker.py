"""FeatureAttacker: a 2-layer MLP re-identification probe for feature-leakage
estimation (ref: src/privacy/attacker.py:5-18), and its training loop (ref:
src/run_privacy.py:309-326 trains it with Adam and cross-entropy for a few
epochs); counterpart of the JAX package's ``privacy/attacker.py``.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..train.finetune_engine import init_model


class FeatureAttacker(nn.Module):
    """``Linear(d, d)`` -> ReLU -> ``Linear(d, num_classes)`` (flax's
    ``Dense_0``/``Dense_1``)."""

    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim)
        self.fc2 = nn.Linear(dim, num_classes)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(z)))


def train_attacker(
    generator: torch.Generator,
    embeddings: torch.Tensor,    # [N, D] clean or perturbed embeddings
    labels: torch.Tensor,        # [N] int
    num_classes: int,
    epochs: int = 10,
    lr: float = 1e-3,
    batch_size: int | None = None,
    init_state: Mapping[str, torch.Tensor] | None = None,
) -> tuple[FeatureAttacker, float]:
    """Train the probe; returns (module, final top-1 on the training set).

    The probe starts from flax's ``Dense`` init (lecun-normal kernels, zero
    biases) drawn from ``generator`` (on the embeddings' device), or from
    ``init_state``. Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8),
    fresh each call; cross-entropy on fp32 logits. Every epoch draws a
    permutation and takes ``n // batch_size`` steps; ``batch_size=None`` is
    one whole-dataset step per epoch, the reference's loop
    (ref: src/run_privacy.py:313-320). Top-1 is measured on the same set it
    trained on: the metric is leakage, not generalization (ref: :322-337).
    """
    model = FeatureAttacker(embeddings.shape[-1], num_classes).to(embeddings.device)
    if init_state is None:
        init_model(model, generator)
    else:
        model.load_state_dict(init_state)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    n = embeddings.shape[0]
    batch_size = batch_size or n
    steps = max(1, n // batch_size)
    labels = labels.long()
    for _ in range(epochs):
        order = torch.randperm(n, generator=generator, device=embeddings.device)
        for s in range(steps):
            idx = order[s * batch_size:(s + 1) * batch_size]
            loss = F.cross_entropy(model(embeddings[idx]).float(), labels[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    with torch.no_grad():
        top1 = float((model(embeddings).argmax(dim=1) == labels).float().mean())
    return model, top1
