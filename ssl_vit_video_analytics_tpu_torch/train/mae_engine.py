"""MAE train steps for SSL pipelines B (pixel) and C (feature tokens)
(counterpart of the JAX package's ``train/mae_engine.py``, without pipeline
parallelism).

Pipeline B: on-device normalize -> tube mask -> norm-pix patch target ->
TinyVideoMAE (train mode) -> masked MSE -> gradients -> optimizer.
Pipeline C (ref: src/mae/engine.py:14-162): on-device normalize -> per-clip
horizontal flip (``dataset.augment``) -> random or tube token mask at this
call's ratio -> TinyViTMAE -> masked feature loss -> optimizer, with the
reference's gradient accumulation, non-finite skip and collapse detector
(pred_std < 0.05 -> [WARN:pred_std_low]) through :func:`wrap_accum_and_skip`
and the step metrics. Masks, flips and stochastic-depth decisions come from
an explicit generator, or are passed in (tests inject the JAX draws).
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.masking import _topk_mask, get_tube_mask
from ..ops.patchify import patchify
from ..ops.preprocess import normalize_clip
from .losses import build_mae_loss, mae_loss_l2, reconstruction_error_stats
from .state import ApplyIfFinite, MultiSteps, TrainState, apply_updates, global_norm

COLLAPSE_STD_THRESHOLD = 0.05  # ref: src/mae/engine.py:143-145


def make_pixel_mae_step(model, mask_ratio: float, patch_size: int = 8,
                        norm_pix_loss: bool = True,
                        compute_dtype: torch.dtype = torch.float32,
                        moe_aux_weight: float = 0.0):
    """Pipeline-B step: tube mask -> TinyVideoMAE -> masked MSE on pixels
    (ref: src/train_ssl_mae.py:66-89).

    ``moe_aux_weight`` > 0 with a MoE decoder (``model.decoder_moe_experts``
    > 0) adds that weight times the mean of the decoder blocks' Switch
    load-balance auxiliaries to the loss, and reports the mean as the
    ``moe_aux`` metric (1 at perfect balance). A dense decoder, or weight 0,
    runs the plain step. (The JAX step refuses its pipeline-parallel decoder
    with MoE; the port has no pipeline-parallel decoder yet.)

    Returns ``step(state, batch, generator, mask=None, drop=None) ->
    (state, metrics)``; ``state`` is updated in place. ``batch["clip"]`` is
    uint8 ``[B, T, H, W, 3]`` on the model's device; ``mask`` ``[B, T, L]``
    bool and ``drop`` (``model.draw_drop_path``) replace the draws from
    ``generator``. Metrics are device scalars: ``loss``, ``pred_std``,
    ``grad_norm`` (of this call's gradient, before accumulation) and
    ``collapse``, and ``moe_aux`` with the auxiliary on.
    """
    moe_aux_on = moe_aux_weight > 0 and getattr(model, "decoder_moe_experts", 0)

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
        if moe_aux_on:
            pred, auxes = model(clip, mask, drop, with_aux=True)
            aux = torch.stack(auxes).mean()  # over the decoder's MoE blocks
            loss = (mae_loss_l2(pred, target, flat_mask, normalize_target=norm_pix_loss)
                    + moe_aux_weight * aux)
        else:
            pred = model(clip, mask, drop)
            loss = mae_loss_l2(pred, target, flat_mask, normalize_target=norm_pix_loss)
        grads = torch.autograd.grad(loss, state.params)
        apply_updates(state, grads)
        pred_std = pred.detach().float().std(unbiased=False)
        metrics = {"loss": loss.detach(), "pred_std": pred_std,
                   "grad_norm": global_norm(grads),
                   "collapse": (pred_std < COLLAPSE_STD_THRESHOLD).float()}
        if moe_aux_on:
            metrics["moe_aux"] = aux.detach()
        return state, metrics

    return step


def traced_mask_count(n: int, mask_ratio: float) -> int:
    """``max(1, round(n * ratio))`` with the product in fp32 and round half
    to even, as the JAX step computes it on its traced fp32 ratio."""
    return max(1, int(np.round(np.float32(n) * np.float32(mask_ratio))))


def token_mae_loss_and_grads(model, params, clip, token_mask, drop, loss_fn):
    """Train-mode TinyViTMAE forward of a normalized ``clip``, the masked
    feature loss and its gradients for ``params``. Returns ``(loss, rec,
    target, grads)``."""
    model.train()
    rec, target = model(clip, token_mask, drop)
    loss = loss_fn(rec, target, token_mask)
    return loss.detach(), rec.detach(), target, torch.autograd.grad(loss, params)


def make_token_mae_step(model, tokens_per_frame: int, mask_mode: str = "random",
                        loss_type: str = "l2", normalize_target: bool = True,
                        augment_hflip: bool = False,
                        compute_dtype: torch.dtype = torch.float32):
    """Pipeline-C step: token mask -> TinyViTMAE -> masked feature loss.

    Returns ``step(state, batch, generator, mask_ratio, token_mask=None,
    flip=None, drop=None) -> (state, metrics)``; ``state`` is updated in
    place. ``mask_ratio`` is a per-call float (the epoch schedule); the mask
    counts ``max(1, round(N * ratio))`` tokens (random) or positions a frame
    (tube) as :func:`traced_mask_count`. ``token_mask`` ``[B, T*P]`` bool,
    ``flip`` ``[B]`` bool (the reference's clip-level p=0.5 horizontal flip,
    ref: src/datasets/mae_dataset.py:118, with ``augment_hflip``) and
    ``drop`` replace the draws from ``generator``. Metrics are device
    scalars: ``loss``, ``mae_l1``, ``mae_l2``, ``pred_std``, ``target_std``,
    ``grad_norm`` (of this call's gradient, before accumulation) and
    ``collapse``.
    """
    loss_fn = build_mae_loss(loss_type, normalize_target=normalize_target)
    if mask_mode not in ("random", "tube"):
        raise ValueError(f"Unknown mask_mode: {mask_mode}")
    P = tokens_per_frame

    def step(state: TrainState, batch: dict, generator: torch.Generator, mask_ratio: float,
             token_mask: torch.Tensor | None = None, flip: torch.Tensor | None = None,
             drop: list | None = None):
        clip = normalize_clip(batch["clip"], dtype=compute_dtype)
        B, T = clip.shape[0], clip.shape[1]
        if token_mask is None:
            n = T * P if mask_mode == "random" else P
            token_mask = _topk_mask(generator, B, n, traced_mask_count(n, mask_ratio),
                                    clip.device)
            if mask_mode == "tube":
                token_mask = token_mask.repeat(1, T)
        if augment_hflip:
            if flip is None:
                flip = torch.rand(B, generator=generator, device=generator.device) < 0.5
            clip = torch.where(flip.to(clip.device)[:, None, None, None, None],
                               clip.flip(3), clip)
        if drop is None:
            drop = model.draw_drop_path(B, T, generator, device=clip.device)
        token_mask = token_mask.to(clip.device)
        loss, rec, target, grads = token_mae_loss_and_grads(model, state.params, clip,
                                                            token_mask, drop, loss_fn)
        apply_updates(state, grads)
        stats = reconstruction_error_stats(rec, target, token_mask)
        metrics = {"loss": loss, **stats, "grad_norm": global_norm(grads),
                   "collapse": (stats["pred_std"] < COLLAPSE_STD_THRESHOLD).float()}
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
