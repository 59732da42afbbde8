"""MAE train steps for SSL pipelines B (pixel) and C (feature tokens)
(counterpart of the JAX package's ``train/mae_engine.py``).

Pipeline B: on-device normalize -> tube mask -> norm-pix patch target ->
TinyVideoMAE (train mode) -> masked MSE -> gradients -> optimizer.
Pipeline C (ref: src/mae/engine.py:14-162): on-device normalize -> per-clip
horizontal flip (``dataset.augment``) -> random or tube token mask at this
call's ratio -> TinyViTMAE -> masked feature loss -> optimizer, with the
reference's gradient accumulation, non-finite skip and collapse detector
(pred_std < 0.05 -> [WARN:pred_std_low]) through :func:`wrap_accum_and_skip`
and the step metrics. Masks, flips and stochastic-depth decisions come from
an explicit generator, or are passed in (tests inject the JAX draws).

Under a ``data`` or ``seq`` mesh (``parallel/mesh.py``) each rank holds its
rows or frames of the global batch. Every draw is made for the global batch
from the same generator on every rank, and each rank keeps its part, so a
world of N ranks takes the draws of one device. Each rank's loss is its
share of the global loss (its masked sum over the global masked count);
BatchNorm statistics, the MoE auxiliary and the reported statistics are the
global batch's, and the gradients are summed over the group before the
optimizer (``train/state.apply_updates``).

Under model sharding the batch is split over the mesh's ``data`` axis
alone and whole over ``expert`` and ``model`` (``parallel/ep.py``,
``parallel/tp.py``: the model was cut before the step was made); the
global norm and the finite check see every shard once
(``train/state.Shards``). Pipeline B's decoder can instead run pipeline
parallel over a ``pipe`` mesh (``pp_mesh``, ``parallel/pp.py``): the batch
is whole on every stage, and the loss and metrics come from the last.

Each call of a step is a ``train.step`` span (``utils/tracing.py``; the
``train.steps`` counter counts the calls) over ``train.forward`` (the model and the loss),
``train.backward`` (the gradients) and ``train.update`` (the optimizer);
a pipelined decoder's forward and backward interleave, and are left as
part of the step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.masking import _topk_mask, get_tube_mask
from ..models.layers import global_batch
from ..ops.patchify import patchify
from ..ops.preprocess import normalize_clip
from ..parallel.collectives import all_reduce
from ..parallel.mesh import global_clip_shape, local_draws, local_part
from ..parallel.pp import Pipeline
from ..utils import tracing
from .losses import build_mae_loss, global_std, mae_loss_l2, reconstruction_error_stats
from .state import (ApplyIfFinite, MultiSteps, TrainState, apply_updates, global_norm,
                    shards_of)

COLLAPSE_STD_THRESHOLD = 0.05  # ref: src/mae/engine.py:143-145

# calls of a train step (of either pipeline) in this process
STEPS = tracing.counter("train.steps")


def _traced(step):
    """``step`` as one ``train.step`` span a call, counted in ``STEPS``."""

    @functools.wraps(step)
    def traced(state: TrainState, *args, **kwargs):
        STEPS.count += 1
        with tracing.span("train.step"):
            return step(state, *args, **kwargs)

    return traced


def _total(x: torch.Tensor, group) -> torch.Tensor:
    """A share summed over the group that splits the batch (the global
    value of a loss)."""
    return x if group is None else all_reduce(x, group)


def _split(mesh) -> str:
    """What the mesh's batch axis splits: each clip's tokens (``seq``) or
    the clips (``global_batch``'s ``split``)."""
    return "tokens" if mesh is not None and mesh.split_axis == "seq" else "rows"


def pipeline_loss_and_grads(model, params, clip, mask, drop, loss_of_pred, mesh,
                            n_micro: int):
    """Pipeline B's forward and backward with the decoder's blocks pipelined
    over ``mesh``'s ``pipe`` line (``parallel/pp.py``). Returns ``(loss,
    pred, grads)``: the loss and prediction on the last stage (None
    elsewhere), and this stage's gradients of ``params`` (zeros where none
    arises on it: the encoder's beyond stage 0, the head's before the
    last)."""
    pipe = Pipeline(mesh, n_micro)
    for p in params:
        p.grad = None
    with torch.set_grad_enabled(pipe.first):
        x = model.embed_tokens(clip, mask, drop)
    blocks = [model.decoder.blocks[i] for i in model.pipe_blocks]

    def run_stage(h):
        for blk in blocks:
            h = blk(h)
        return h

    y = pipe.forward(run_stage, x)
    loss = pred = grad = None
    if pipe.last:
        y_in = y.detach().requires_grad_()
        pred = model.predict_pixels(y_in)
        loss = loss_of_pred(pred)
        loss.backward()
        grad = y_in.grad
    x_grad = pipe.backward(grad)
    if pipe.first:
        torch.autograd.backward(x, x_grad)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    for p in params:
        p.grad = None
    return loss, pred, grads


def make_pixel_mae_step(model, mask_ratio: float, patch_size: int = 8,
                        norm_pix_loss: bool = True,
                        compute_dtype: torch.dtype = torch.float32,
                        moe_aux_weight: float = 0.0, mesh=None, pp_mesh=None,
                        pp_microbatches: int | None = None):
    """Pipeline-B step: tube mask -> TinyVideoMAE -> masked MSE on pixels
    (ref: src/train_ssl_mae.py:66-89).

    ``moe_aux_weight`` > 0 with a MoE decoder (``model.decoder_moe_experts``
    > 0) adds that weight times the mean of the decoder blocks' Switch
    load-balance auxiliaries to the loss, and reports the mean as the
    ``moe_aux`` metric (1 at perfect balance). A dense decoder, or weight 0,
    runs the plain step.

    Returns ``step(state, batch, generator, mask=None, drop=None) ->
    (state, metrics)``; ``state`` is updated in place. ``batch["clip"]`` is
    uint8 ``[B, T, H, W, 3]`` on the model's device; ``mask`` ``[B, T, L]``
    bool and ``drop`` (``model.draw_drop_path``) replace the draws from
    ``generator``. Metrics are device scalars: ``loss``, ``pred_std``,
    ``grad_norm`` (of this call's gradient, before accumulation) and
    ``collapse``, and ``moe_aux`` with the auxiliary on.

    ``mesh``: a ``data`` or ``seq`` mesh, or a ``data`` x ``expert`` or
    ``data`` x ``model`` mesh over which ``model`` was cut; ``batch`` then
    holds this rank's rows or frames, ``mask`` and ``drop`` (when given)
    are the global batch's, and the metrics are the global batch's on every
    rank. ``pp_mesh`` (a ``pipe`` mesh over whose stages ``model`` was cut,
    in place of ``mesh``): the decoder's blocks run pipeline parallel over
    ``pp_microbatches`` microbatches (default: one a stage); the batch is
    whole on every stage. As in JAX the MoE decoder is refused there.
    """
    if pp_mesh is not None:
        if getattr(model, "decoder_moe_experts", 0):
            raise ValueError("pipeline-parallel decoder does not support the "
                             "MoE decoder (use device.expert_parallel)")
        if mesh is not None:
            raise ValueError(f"pipeline parallelism runs on its own mesh, not with {mesh}")
        mesh = pp_mesh
        n_micro = pp_microbatches or pp_mesh.size("pipe")
    moe_aux_on = moe_aux_weight > 0 and getattr(model, "decoder_moe_experts", 0)
    group = None if mesh is None else mesh.batch_group

    def step(state: TrainState, batch: dict, generator: torch.Generator,
             mask: torch.Tensor | None = None, drop: list | None = None):
        clip = normalize_clip(batch["clip"], dtype=compute_dtype)
        B, T = clip.shape[0], clip.shape[1]
        Bg, Tg, t0 = global_clip_shape(mesh, B, T)
        L = (clip.shape[2] // patch_size) * (clip.shape[3] // patch_size)
        if mask is None:
            mask = get_tube_mask(generator, Bg, Tg, L, mask_ratio, device=clip.device)
        if drop is None:
            drop = model.draw_drop_path(Bg, Tg, generator, device=clip.device)
        mask = local_part(mask.to(clip.device), mesh, Tg)
        drop = local_draws(drop, mesh, Bg, Tg)
        target = patchify(clip.float(), patch_size)               # [B, T*L, p*p*3]
        flat_mask = mask.reshape(B, T * L)

        model.train()
        shards = shards_of(state.params, mesh)
        if pp_mesh is not None:
            loss, pred, grads = pipeline_loss_and_grads(
                model, state.params, clip, mask, drop,
                lambda p: mae_loss_l2(p, target, flat_mask, normalize_target=norm_pix_loss),
                pp_mesh, n_micro)
            with tracing.span("train.update"):
                apply_updates(state, grads, None, shards)
            # the last stage's loss and prediction statistics, on every stage
            shared = (clip.new_zeros(2, dtype=torch.float32) if loss is None
                      else torch.stack([loss.detach(), global_std(pred.detach())]))
            loss, pred_std = all_reduce(shared, pp_mesh.group("pipe"))
        else:
            with global_batch(model, group, _split(mesh)):
                with tracing.span("train.forward"):
                    if moe_aux_on:
                        pred, auxes = model(clip, mask, drop, with_aux=True, frame_offset=t0)
                        aux = torch.stack(auxes).mean()  # over the decoder's MoE blocks
                        loss = (mae_loss_l2(pred, target, flat_mask,
                                            normalize_target=norm_pix_loss, group=group)
                                + moe_aux_weight * aux)
                    else:
                        pred = model(clip, mask, drop, frame_offset=t0)
                        loss = mae_loss_l2(pred, target, flat_mask,
                                           normalize_target=norm_pix_loss, group=group)
                with tracing.span("train.backward"):
                    grads = torch.autograd.grad(loss, state.params)
            with tracing.span("train.update"):
                apply_updates(state, grads, group, shards)
            pred_std = global_std(pred.detach(), group)
            loss = _total(loss.detach(), group)
        metrics = {"loss": loss, "pred_std": pred_std,
                   "grad_norm": global_norm(grads, shards),
                   "collapse": (pred_std < COLLAPSE_STD_THRESHOLD).float()}
        if moe_aux_on:
            metrics["moe_aux"] = _total(aux.detach(), group)
        return state, metrics

    return _traced(step)


def traced_mask_count(n: int, mask_ratio: float) -> int:
    """``max(1, round(n * ratio))`` with the product in fp32 and round half
    to even, as the JAX step computes it on its traced fp32 ratio."""
    return max(1, int(np.round(np.float32(n) * np.float32(mask_ratio))))


def token_mae_loss_and_grads(model, params, clip, token_mask, drop, loss_fn, group=None,
                             split: str = "rows"):
    """Train-mode TinyViTMAE forward of a normalized ``clip``, the masked
    feature loss and its gradients for ``params`` (with a mesh's batch
    ``group``: this rank's share of the loss, the group's BatchNorm
    statistics). Returns ``(loss, rec, target, grads)``."""
    model.train()
    with global_batch(model, group, split):
        with tracing.span("train.forward"):
            rec, target = model(clip, token_mask, drop)
            loss = loss_fn(rec, target, token_mask)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, params)
    return loss.detach(), rec.detach(), target, grads


def make_token_mae_step(model, tokens_per_frame: int, mask_mode: str = "random",
                        loss_type: str = "l2", normalize_target: bool = True,
                        augment_hflip: bool = False,
                        compute_dtype: torch.dtype = torch.float32, mesh=None):
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

    ``mesh``: as :func:`make_pixel_mae_step` (under ``seq`` the model's
    decoder is built with ``attn_impl="sp"``; under ``model`` the model was
    cut by ``parallel/tp.py``).
    """
    group = None if mesh is None else mesh.batch_group
    loss_fn = build_mae_loss(loss_type, normalize_target=normalize_target, group=group)
    if mask_mode not in ("random", "tube"):
        raise ValueError(f"Unknown mask_mode: {mask_mode}")
    P = tokens_per_frame

    def step(state: TrainState, batch: dict, generator: torch.Generator, mask_ratio: float,
             token_mask: torch.Tensor | None = None, flip: torch.Tensor | None = None,
             drop: list | None = None):
        clip = normalize_clip(batch["clip"], dtype=compute_dtype)
        B, T = clip.shape[0], clip.shape[1]
        Bg, Tg, _ = global_clip_shape(mesh, B, T)
        if token_mask is None:
            n = Tg * P if mask_mode == "random" else P
            token_mask = _topk_mask(generator, Bg, n, traced_mask_count(n, mask_ratio),
                                    clip.device)
            if mask_mode == "tube":
                token_mask = token_mask.repeat(1, Tg)
        if augment_hflip:
            if flip is None:
                flip = torch.rand(Bg, generator=generator, device=generator.device) < 0.5
            flip = local_part(flip.to(clip.device), mesh)
            clip = torch.where(flip[:, None, None, None, None], clip.flip(3), clip)
        if drop is None:
            drop = model.draw_drop_path(Bg, Tg, generator, device=clip.device)
        drop = local_draws(drop, mesh, Bg, Tg)
        token_mask = local_part(token_mask.to(clip.device), mesh, Tg)
        loss, rec, target, grads = token_mae_loss_and_grads(model, state.params, clip,
                                                            token_mask, drop, loss_fn, group,
                                                            _split(mesh))
        shards = shards_of(state.params, mesh)
        with tracing.span("train.update"):
            apply_updates(state, grads, group, shards)
        loss = _total(loss, group)
        stats = reconstruction_error_stats(rec, target, token_mask, group)
        metrics = {"loss": loss, **stats, "grad_norm": global_norm(grads, shards),
                   "collapse": (stats["pred_std"] < COLLAPSE_STD_THRESHOLD).float()}
        return state, metrics

    return _traced(step)


def wrap_accum_and_skip(tx, accum_steps: int = 1, skip_nonfinite: bool = True):
    """Gradient accumulation + non-finite-update skip (ref:
    src/mae/engine.py:89-108): ``apply_if_finite`` inside ``MultiSteps``."""
    if skip_nonfinite:
        tx = ApplyIfFinite(tx, max_consecutive_errors=10_000)
    if accum_steps > 1:
        tx = MultiSteps(tx, accum_steps)
    return tx
