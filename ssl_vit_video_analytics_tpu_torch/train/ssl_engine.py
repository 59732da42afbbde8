"""SSL pipeline A engine: EMA teacher-student masked feature modeling +
VICReg variance + 4-way temporal-order prediction (TOP) (counterpart of the
JAX package's ``train/ssl_engine.py``; ref: src/train_ssl.py:165-295).

- The teacher is the EMA copy of the student's params, in eval mode over
  the FULL sequence, with the student's BatchNorm running statistics as
  they stand at the start of the step (``torch.func.functional_call`` with
  the EMA params and the student's own buffers, before the student runs);
  the student sees masked frames.
- loss = mfm_weight * cosine(pred_masked, teacher_masked)
  + var_weight * variance_hinge(pred_masked)
  (+ top_weight * CE over 4-way frame permutations on the steps where TOP
  is on, on a random subsample of the batch).
- BatchNorm statistics move in the JAX order: student ``forward_tokens``,
  then ``predictor``, then the train-mode TOP forward.
- EMA update of every param after each optimizer step (ref: :36-39, :265).

The frame mask, the TOP subsample and the TOP labels come from an explicit
generator, or are passed in (tests inject the JAX draws).

Under a ``data`` mesh each rank holds its rows of the global batch; the
draws are made for the global batch on every rank and each rank keeps its
part (its rows of the mask; the subsampled clips that are its rows, with
their labels: a rank may hold none). Each rank's loss is its share of the
global loss: the cosine and TOP sums over the global counts, and the
VICReg variance, which every rank computes whole over the embeddings of
all ranks (a differentiable all-gather), divided by the mesh size. The
predictor's and the encoder's BatchNorm statistics are the global batch's;
the gradients are summed before the optimizer, so the replicas, and their
EMA teachers, stay identical.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..data.masking import frame_mask
from ..models.layers import global_batch
from ..ops.preprocess import normalize_clip
from ..parallel.collectives import all_gather, all_gather_cat, all_reduce
from .losses import l2_normalize
from .state import TrainState, apply_updates, update_ema


def masked_cosine_loss(p: torch.Tensor, z: torch.Tensor, mask: torch.Tensor,
                       group=None) -> torch.Tensor:
    """2 - 2*cos per masked row, mean over masked rows (with ``group``:
    this rank's sum over the group's masked rows).

    p, z: ``[B, T, D]`` L2-normalized; mask: ``[B, T]`` bool.
    """
    m = mask.float()
    per_row = 2.0 - 2.0 * (p * z).sum(dim=-1)
    count = m.sum() if group is None else all_reduce(m.sum(), group)
    return (per_row * m).sum() / torch.clamp(count, min=1.0)


def masked_variance_loss(z: torch.Tensor, mask: torch.Tensor, target_std: float = 1.0,
                         eps: float = 1e-4) -> torch.Tensor:
    """VICReg hinge over masked rows only (weighted mean/var across rows)."""
    m = mask.float()[..., None]
    denom = torch.clamp(m.sum(), min=1.0)
    mean = (z * m).sum(dim=(0, 1), keepdim=True) / denom
    var = (((z - mean) ** 2) * m).sum(dim=(0, 1)) / denom
    return F.relu(target_std - torch.sqrt(var + eps)).mean()


def perm_table_4way(T: int) -> np.ndarray:
    """[4, T] permutation index table (ref: src/train_ssl.py:55-74):
    identity / reverse / swap-halves / rotate-quarter."""
    idx = np.arange(T)
    half, q = T // 2, T // 4
    rows = [
        idx,
        idx[::-1],
        np.concatenate([idx[half:], idx[:half]]),
        idx if q == 0 else np.concatenate([idx[q:], idx[:q]]),
    ]
    return np.stack(rows).astype(np.int32)


def permute_frames_4way(generator: torch.Generator | None, clip: torch.Tensor,
                        labels: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample 4-way frame permutation -> ``(clip_top, labels [B])``;
    ``labels`` (in 0..3) replace the draw from ``generator``."""
    B, T = clip.shape[0], clip.shape[1]
    if labels is None:
        labels = torch.randint(0, 4, (B,), generator=generator, device=generator.device)
    labels = labels.to(clip.device).long()
    perms = torch.from_numpy(perm_table_4way(T)).to(clip.device).long()[labels]  # [B, T]
    rows = torch.arange(B, device=clip.device)[:, None]
    return clip[rows, perms], labels


class SSLObjective:
    """Pipeline A's loss with its config (``ssl_objectives`` of the yaml)
    and the TOP switch of one step variant."""

    def __init__(self, ssl_cfg: dict, with_top: bool):
        self.mask_ratio = float(ssl_cfg.get("mask_ratio", 0.75))
        self.mfm_weight = float(ssl_cfg.get("mfm_weight", 1.0))
        self.var_weight = float(ssl_cfg.get("var_weight", 25.0))
        self.var_target_std = float(ssl_cfg.get("var_target_std", 1.0))
        self.var_eps = float(ssl_cfg.get("var_eps", 1e-4))
        self.top_weight = float(ssl_cfg.get("top_weight", 1.0))
        self.top_subsample = float(ssl_cfg.get("top_subsample", 1.0))
        self.top_detach = bool(ssl_cfg.get("top_detach_backbone", False))
        self.ema_momentum = float(ssl_cfg.get("ema_momentum", 0.996))
        self.top_on = with_top and self.top_weight > 0

    def top_count(self, B: int) -> int | None:
        """Clips in the TOP branch's subsample, None for the whole batch."""
        return max(2, int(B * self.top_subsample)) if self.top_subsample < 1.0 else None

    def loss_and_grads(self, model, params, ema, clip, mask, top_sel=None, top_labels=None,
                       mesh=None, top_count=None):
        """Teacher, student and TOP forwards of a normalized ``clip`` and the
        gradients of the loss for ``params``. ``top_sel`` (the subsample's
        clip indices, when ``top_subsample < 1``) and ``top_labels`` are the
        TOP draws. Under a ``data`` mesh they are this rank's (its
        subsampled rows, local indices) and ``top_count`` is the global
        subsample's size; the loss is this rank's share. Returns ``(loss,
        metrics, grads)`` with the global loss and metrics."""
        group = None if mesh is None else mesh.group()
        B, T = clip.shape[0], clip.shape[1]
        with torch.no_grad():
            model.eval()
            ctx_t = functional_call(model, ema, (clip, None))
            z_t = l2_normalize(ctx_t.float(), 1e-12)

        model.train()
        with global_batch(model, group):
            ctx_s = model(clip, mask)
            D = ctx_s.shape[-1]
            z_s = l2_normalize(model.predictor(ctx_s.reshape(B * T, D)).float()
                               .reshape(B, T, D), 1e-12)
            loss_mfm = masked_cosine_loss(z_s, z_t, mask, group)
            if mesh is None:
                loss_var = masked_variance_loss(z_s, mask, self.var_target_std, self.var_eps)
                var_share = loss_var
            else:
                # whole on every rank over the gathered embeddings: 1/n of
                # it in each share (the gather's backward sums the n)
                loss_var = masked_variance_loss(all_gather(z_s, 0, group),
                                                all_gather_cat(mask, group),
                                                self.var_target_std, self.var_eps)
                var_share = loss_var / mesh.size()
            loss = self.mfm_weight * loss_mfm + self.var_weight * var_share
            metrics = {"mfm": loss_mfm.detach(), "var": loss_var.detach()}
            if self.top_on:
                clip_src = clip if top_sel is None else clip[top_sel.to(clip.device)]
                clip_top, labels = permute_frames_4way(None, clip_src, top_labels)
                # train mode as the reference (src/train_ssl.py:238-241): batch
                # statistics in the TOP branch, running statistics moved by it too
                feat = model(clip_top).mean(dim=1)
                if self.top_detach:
                    feat = feat.detach()
                logits = model.top_logits(feat[:, None, :]).float()
                if mesh is None:
                    loss_top = F.cross_entropy(logits, labels)
                else:
                    loss_top = (F.cross_entropy(logits, labels, reduction="sum")
                                / max(int(top_count), 1))
                loss = loss + self.top_weight * loss_top
                metrics["top"] = loss_top.detach()
            metrics["loss"] = loss.detach()
            # without TOP the TOP head gets a zero gradient, as under jax.grad:
            # its weight decay and moments still move
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if mesh is not None:
            for k in ("mfm", "top", "loss"):  # shares -> the global values
                if k in metrics:
                    metrics[k] = all_reduce(metrics[k], group)
        return metrics["loss"], metrics, grads


def _local_top_draws(mesh, B: int, top_sel, top_labels):
    """This rank's part of the global TOP draws: the subsampled clips among
    its rows (as local indices, in the subsample's order) and their labels;
    without a subsample, its rows' labels."""
    rows = mesh.block(B * mesh.size())
    if top_sel is None:
        return None, top_labels[rows]
    sel = top_sel.to(top_labels.device)
    mine = (sel >= rows.start) & (sel < rows.stop)
    return sel[mine] - rows.start, top_labels[mine]


def make_ssl_step(model, ssl_cfg: dict, with_top: bool,
                  compute_dtype: torch.dtype = torch.float32, mesh=None):
    """The pipeline-A step, one variant per TOP on/off (the host picks one
    per step, as the JAX entry picks a compiled variant).

    Returns ``step(state, batch, generator, mask=None, top_sel=None,
    top_labels=None) -> (state, metrics)``; ``state`` (its ``ema`` the
    teacher) is updated in place. ``mask`` ``[B, T]`` bool, ``top_sel``
    (``max(2, int(B * top_subsample))`` clip indices) and ``top_labels``
    replace the draws from ``generator``. Metrics are device scalars:
    ``mfm``, ``var``, ``top`` (with TOP) and ``loss``.

    ``mesh``: a ``data`` mesh; ``batch`` holds this rank's rows, the draws
    (given or not) are the global batch's, the metrics the global ones.
    """
    obj = SSLObjective(ssl_cfg, with_top)
    if mesh is not None and mesh.axes != ("data",):
        raise ValueError(f"pipeline A runs data-parallel only, not over {mesh}")

    def step(state: TrainState, batch: dict, generator: torch.Generator,
             mask: torch.Tensor | None = None, top_sel: torch.Tensor | None = None,
             top_labels: torch.Tensor | None = None):
        clip = normalize_clip(batch["clip"], dtype=compute_dtype)
        B, T = clip.shape[0], clip.shape[1]
        Bg = B if mesh is None else B * mesh.size()
        if mask is None:
            mask = frame_mask(generator, Bg, T, obj.mask_ratio, device=clip.device)
        mask = mask.to(clip.device)
        k = None
        if obj.top_on:
            k = obj.top_count(Bg)
            if top_sel is None and k is not None:
                top_sel = torch.randperm(Bg, generator=generator, device=generator.device)[:k]
            if top_labels is None:
                top_labels = torch.randint(0, 4, (Bg if k is None else k,), generator=generator,
                                           device=generator.device)
        if mesh is not None:
            mask = mask[mesh.block(Bg)]
            if obj.top_on:
                top_sel, top_labels = _local_top_draws(mesh, B, top_sel, top_labels)
        loss, metrics, grads = obj.loss_and_grads(
            model, state.params, state.ema, clip, mask, top_sel, top_labels, mesh,
            Bg if k is None else k)
        apply_updates(state, grads, None if mesh is None else mesh.group())
        update_ema(state.ema, dict(model.named_parameters()), obj.ema_momentum)
        return state, metrics

    return step
