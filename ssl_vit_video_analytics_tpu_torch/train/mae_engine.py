"""Pipeline-B MAE train step (counterpart of the JAX package's
``train/mae_engine.make_pixel_mae_step`` without pipeline parallelism).

One step: on-device normalize -> tube mask -> norm-pix patch target ->
TinyVideoMAE (train mode) -> masked MSE -> gradients -> optimizer. The mask
and the stochastic-depth decisions come from an explicit generator, or are
passed in (tests inject the JAX mask).
"""
from __future__ import annotations

import torch

from ..data.masking import get_tube_mask
from ..ops.patchify import patchify
from ..ops.preprocess import normalize_clip
from .losses import mae_loss_l2
from .state import ApplyIfFinite, MultiSteps, TrainState, apply_updates, global_norm

COLLAPSE_STD_THRESHOLD = 0.05  # ref: src/mae/engine.py:143-145


def make_pixel_mae_step(model, mask_ratio: float, patch_size: int = 8,
                        norm_pix_loss: bool = True,
                        compute_dtype: torch.dtype = torch.float32):
    """Pipeline-B step: tube mask -> TinyVideoMAE -> masked MSE on pixels
    (ref: src/train_ssl_mae.py:66-89).

    Returns ``step(state, batch, generator, mask=None, drop=None) ->
    (state, metrics)``; ``state`` is updated in place. ``batch["clip"]`` is
    uint8 ``[B, T, H, W, 3]`` on the model's device; ``mask`` ``[B, T, L]``
    bool and ``drop`` (``model.draw_drop_path``) replace the draws from
    ``generator``. Metrics are device scalars: ``loss``, ``pred_std``,
    ``grad_norm`` (of this call's gradient, before accumulation) and
    ``collapse``.
    """

    def step(state: TrainState, batch: dict, generator: torch.Generator,
             mask: torch.Tensor | None = None, drop: list | None = None):
        clip = normalize_clip(batch["clip"], dtype=compute_dtype)
        B, T = clip.shape[0], clip.shape[1]
        L = (clip.shape[2] // patch_size) * (clip.shape[3] // patch_size)
        if mask is None:
            mask = get_tube_mask(generator, B, T, L, mask_ratio, device=clip.device)
        if drop is None:
            drop = model.draw_drop_path(B, T, generator, device=clip.device)
        target = patchify(clip.float(), patch_size)               # [B, T*L, p*p*3]
        flat_mask = mask.reshape(B, T * L)

        model.train()
        pred = model(clip, mask, drop)
        loss = mae_loss_l2(pred, target, flat_mask, normalize_target=norm_pix_loss)
        grads = torch.autograd.grad(loss, state.params)
        apply_updates(state, grads)
        pred_std = pred.detach().float().std(unbiased=False)
        metrics = {"loss": loss.detach(), "pred_std": pred_std,
                   "grad_norm": global_norm(grads),
                   "collapse": (pred_std < COLLAPSE_STD_THRESHOLD).float()}
        return state, metrics

    return step


def wrap_accum_and_skip(tx, accum_steps: int = 1, skip_nonfinite: bool = True):
    """Gradient accumulation + non-finite-update skip (ref:
    src/mae/engine.py:89-108): ``apply_if_finite`` inside ``MultiSteps``."""
    if skip_nonfinite:
        tx = ApplyIfFinite(tx, max_consecutive_errors=10_000)
    if accum_steps > 1:
        tx = MultiSteps(tx, accum_steps)
    return tx
