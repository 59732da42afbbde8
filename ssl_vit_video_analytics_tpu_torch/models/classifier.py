"""VideoClassifier: per-frame backbone embedding -> temporal mean -> linear
head (counterpart of the JAX package's ``models/classifier.py``). The T
frames of a clip are encoded as one ``[B*T]`` batch.

In training the backbone's stochastic-depth decisions are an argument
(``drop``, from :meth:`VideoClassifier.draw_drop_path` for the ``B*T``
frames); a backbone without drop path (MobileViT) draws and takes None.
A backbone is ``(frames, drop) -> (feat_map, emb)`` with
``draw_drop_path(n, generator, device)``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class VideoClassifier(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int):
        super().__init__()
        self.backbone = backbone
        self.head = nn.Linear(backbone.embed_dim, num_classes)

    def draw_drop_path(self, batch: int, frames: int, generator: torch.Generator,
                       device=None):
        """The backbone's stochastic-depth decisions for ``batch`` clips of
        ``frames`` frames, or None for a backbone without drop path."""
        return self.backbone.draw_drop_path(batch * frames, generator, device)

    def forward(self, clip: torch.Tensor, drop: list | None = None) -> torch.Tensor:
        """clip: ``[B, T, H, W, 3]`` -> logits ``[B, num_classes]``."""
        return self.classify_embedding(self.video_embedding(clip, drop))

    def video_embedding(self, clip: torch.Tensor, drop: list | None = None) -> torch.Tensor:
        """Temporal mean of per-frame embeddings ``[B, D]``."""
        B, T, H, W, C = clip.shape
        emb = self.frame_embedding(clip.reshape(B * T, H, W, C), drop)
        return emb.reshape(B, T, -1).mean(dim=1)

    def frame_embedding(self, frames: torch.Tensor, drop: list | None = None) -> torch.Tensor:
        """``[N, H, W, 3]`` -> ``[N, D]``; used by the early-exit paths."""
        return self.backbone(frames, drop)[1]

    def classify_embedding(self, emb: torch.Tensor) -> torch.Tensor:
        """``[N, D]`` -> fp32 logits. The flax head has no ``dtype``, so it
        promotes a bf16 embedding to its fp32 parameters; so does this."""
        return F.linear(emb.float(), self.head.weight, self.head.bias)
