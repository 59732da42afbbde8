"""Supervised finetune engine: the four modes, the train and eval steps
(counterpart of the JAX package's ``train/finetune_engine.py``).

Mode semantics follow the reference (ref: src/train_finetune.py:198-210
resolve_mode; :294-313 freeze policy; :334-340 two-stage unfreeze and
optimizer rebuild; :164-195 per-group LRs). Freezing leaves the backbone's
params out of the optimizer (optax's ``set_to_zero``: no update, no weight
decay, no moments) and takes gradients for the trainable params only; the
backbone still runs in train mode, so its BatchNorm statistics move and its
drop path applies, as under the JAX step's ``train=True``.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.classifier import VideoClassifier
from ..models.layers import ConvBNAct, MoeMlp, global_batch
from ..models.mobilevit import MobileViTBackbone
from ..models.tiny_vit import TinyViTBackbone
from ..ops.preprocess import normalize_clip
from ..parallel.collectives import all_reduce
from ..parallel.mesh import local_draws
from ..utils.metrics import topk_accuracy
from ..utils.prng import step_generator
from .state import AdamW, TrainState, apply_updates, make_optimizer

VALID_MODES = ("ft_random", "linear_probe", "ft_ssl", "two_stage")

# flax's lecun_normal: truncated normal (+-2 std) rescaled to unit variance
_TRUNC_STD_CORRECTION = 0.87962566103423978


def resolve_mode(ft_cfg: dict, cli_mode: str | None) -> str:
    mode = cli_mode or ft_cfg.get("experiment", {}).get("mode", "ft_ssl")
    if mode not in VALID_MODES:
        raise ValueError(f"[ERROR] Unknown mode={mode}, must be one of {sorted(VALID_MODES)}")
    return mode


def build_model(num_classes: int, embed_dim: int, dtype: torch.dtype = torch.float32,
                backbone: str = "mobilevit_s",
                backbone_kwargs: dict | None = None) -> VideoClassifier:
    """A ``VideoClassifier`` in eval mode with torch's default init (see
    :func:`init_model` for the flax-like seeded init). ``backbone``:
    "mobilevit_s" (pipeline-A checkpoints) or "tinyvit" (pipeline-B encoder
    checkpoints; its embedding width is the tapped stage's, so ``embed_dim``
    is ignored)."""
    kw = dict(backbone_kwargs or {})
    if backbone in ("tinyvit", "tinyvit_21m"):
        bb = TinyViTBackbone(dtype=dtype, **kw)
    elif backbone in ("mobilevit_s", "mobilevit"):
        bb = MobileViTBackbone(embed_dim, dtype, **kw)
    else:
        raise ValueError(f"[ERROR] Unknown backbone={backbone}")
    return VideoClassifier(bb, num_classes).eval()


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD_CORRECTION
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize ``model`` in place as flax initializes the JAX model:
    lecun-normal conv/dense kernels and MoE expert banks (per expert), zero
    biases, unit BN/LN scales (zero BN scale where a ``ConvBNAct`` asks for
    it: residual MBConvs), BN running
    mean 0 and variance 1, and ``truncated_normal(0.02)`` (within +-0.04)
    for the MAE's and pipeline A's position embeddings and mask tokens.
    Draws from ``generator``."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            _lecun_normal_(m.weight, fan_in, generator)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.weight.shape[1], generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, MoeMlp):
            # variance_scaling(1, fan_in, truncated_normal) with the expert
            # axis as the batch axis: fan-in D for w1, H for w2
            for w in (m.w1, m.w2):
                _lecun_normal_(w, w.shape[1], generator)
            nn.init.zeros_(m.b1)
            nn.init.zeros_(m.b2)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_running_stats()
        for name, p in m.named_parameters(recurse=False):
            if name in ("temporal_pos_embed", "spatial_pos_embed", "mask_token", "pos"):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
    for m in model.modules():  # after their BatchNorm2d children got scale 1
        if isinstance(m, ConvBNAct) and m.bn_zero_init:
            nn.init.zeros_(m.bn.weight)
    return model


def load_pretrained_ssl(model: VideoClassifier,
                        ssl_state: Mapping[str, torch.Tensor]) -> VideoClassifier:
    """Drop an SSL checkpoint's encoder (``encoder.*`` tensors: the port's
    pretraining checkpoint, or a JAX blob through
    ``utils.convert.encoder_state_dict_from_flax``) onto the classifier's
    backbone, in place (ref: src/train_finetune.py:43-63).

    Pipeline B/C: the encoder is the TinyViT nested as ``backbone.encoder``
    (a stage-limit-3 classifier matches the pretraining tap key for key).
    Pipeline A: the encoder IS the MobileViT backbone. Every backbone tensor
    must be filled with one of its shape, or it raises before loading
    anything; values are cast to the backbone's dtypes. The head is
    untouched.
    """
    target = model.backbone.encoder if isinstance(model.backbone, TinyViTBackbone) \
        else model.backbone
    src = {k[len("encoder."):]: v for k, v in ssl_state.items() if k.startswith("encoder.")}
    tgt = target.state_dict()
    missing, extra = sorted(set(tgt) - set(src)), sorted(set(src) - set(tgt))
    if missing or extra:
        raise ValueError(
            "[ERROR] SSL encoder tree does not match classifier backbone "
            f"(missing {missing[:3]}{'...' if len(missing) > 3 else ''}, "
            f"extra {extra[:3]}{'...' if len(extra) > 3 else ''})")
    bad = [(k, tuple(src[k].shape), tuple(t.shape)) for k, t in tgt.items()
           if tuple(src[k].shape) != tuple(t.shape)]
    if bad:
        # same module names but other widths would load silently and crash
        # (or broadcast) later: fail at the checkpoint
        raise ValueError(
            f"[ERROR] SSL encoder leaf shapes do not match classifier backbone "
            f"({len(bad)} mismatched leaves, e.g. {bad[0]})")
    target.load_state_dict({k: src[k].to(t.dtype) for k, t in tgt.items()})
    return model


def trainable_mask(model: VideoClassifier, freeze_backbone: bool) -> list[bool]:
    """One bool per ``model.parameters()``: False under ``backbone`` when
    frozen, True elsewhere."""
    return [not (freeze_backbone and name.split(".")[0] == "backbone")
            for name, _ in model.named_parameters()]


def build_finetune_tx(ft_training_cfg: dict, mode: str, model: VideoClassifier,
                      freeze_backbone: bool) -> AdamW:
    """AdamW with mode-dependent LR structure (ref: src/train_finetune.py:164-195):
    two_stage has a head group at ``head_lr`` and a backbone group at
    ``backbone_lr`` (left out while frozen), each clipped by its own norm;
    the other modes one group at ``learning_rate`` over the trainable params."""
    wd = float(ft_training_cfg.get("weight_decay", 0.05))
    # the reference finetune never clips (src/train_finetune.py has no
    # clip_grad_norm_); grad_clip stays an opt-in config knob
    clip = (float(ft_training_cfg["grad_clip"])
            if ft_training_cfg.get("grad_clip") is not None else None)
    lr = float(ft_training_cfg["learning_rate"])
    if mode == "two_stage":
        named = list(model.named_parameters())
        groups = [{"name": "head", "lr": float(ft_training_cfg.get("head_lr", lr)),
                   "params": [p for n, p in named if n.split(".")[0] != "backbone"]}]
        if not freeze_backbone:
            groups.append({"name": "backbone",
                           "lr": float(ft_training_cfg.get("backbone_lr", lr)),
                           "params": [p for n, p in named if n.split(".")[0] == "backbone"]})
        return AdamW(groups, weight_decay=wd, grad_clip=clip)
    return make_optimizer(model.parameters(), lr, weight_decay=wd, grad_clip=clip,
                          trainable_mask=trainable_mask(model, freeze_backbone))


def _backbone_frozen(model: VideoClassifier, params: Iterable[torch.Tensor]) -> bool:
    trainable = {id(p) for p in params}
    return not any(id(p) in trainable for p in model.backbone.parameters())


def loss_and_grads(model: VideoClassifier, params: list[torch.Tensor], clip: torch.Tensor,
                   labels: torch.Tensor, drop: list | None, mesh=None):
    """Train-mode forward of a normalized ``clip``, cross-entropy on fp32
    logits, and its gradients for ``params``. A backbone with none of its
    params in ``params`` runs without recording its graph (its backward,
    K2 included, is never needed). Under a ``data`` mesh the BatchNorm
    statistics are the global batch's (frozen too: its train-mode forward
    normalizes with them) and the loss is this rank's share, its rows' sum
    over the global batch. Returns ``(loss, logits, grads)``."""
    model.train()
    with global_batch(model, None if mesh is None else mesh.group()):
        with torch.set_grad_enabled(not _backbone_frozen(model, params)):
            emb = model.video_embedding(clip, drop)
        logits = model.classify_embedding(emb)
        if mesh is None:
            loss = F.cross_entropy(logits, labels.long())
        else:
            loss = (F.cross_entropy(logits, labels.long(), reduction="sum")
                    / (labels.shape[0] * mesh.size()))
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), logits.detach(), grads


def make_train_step(model: VideoClassifier, compute_dtype: torch.dtype = torch.float32,
                    augment=None, seed: int = 0, mesh=None):
    """One supervised step: normalize [-> augment] -> train-mode forward ->
    CE -> update.

    Returns ``step(state, batch, generator, drop=None) -> (state, metrics)``;
    ``state`` (its model is ``model``) is updated in place. ``drop``
    (``model.draw_drop_path``) replaces the stochastic-depth draws from
    ``generator``. ``augment`` is an optional ``(clip, generator=) -> clip``
    (``ops/augment.augment_from_cfg``), applied after ``normalize_clip``
    with a generator seeded by ``(seed + 1, state.step)``, as the JAX step
    folds ``state.step`` into ``key(seed + 1)``; the reference has none, so
    the default is None. Metrics are device scalars: ``loss``, ``top1``,
    ``top5``.

    ``mesh``: a ``data`` mesh; ``batch`` holds this rank's rows, the draws
    (augmentation, ``drop`` given or not) are the global batch's, and the
    metrics are the global batch's on every rank.
    """
    if mesh is not None and mesh.axes != ("data",):
        raise ValueError(f"the finetune step runs data-parallel only, not over {mesh}")

    def step(state: TrainState, batch: dict, generator: torch.Generator,
             drop: list | None = None):
        clip = normalize_clip(batch["clip"], dtype=compute_dtype)
        labels = batch["label"]
        B, T = clip.shape[0], clip.shape[1]
        Bg = B if mesh is None else B * mesh.size()
        if augment is not None:
            gen = step_generator(seed + 1, state.step, clip.device)
            clip = (augment(clip, generator=gen) if mesh is None
                    else augment(clip, generator=gen, batch=Bg, rows=mesh.block(Bg)))
        if drop is None:
            drop = model.draw_drop_path(Bg, T, generator, device=clip.device)
        drop = local_draws(drop, mesh, Bg, T)
        loss, logits, grads = loss_and_grads(model, state.params, clip, labels, drop, mesh)
        apply_updates(state, grads, None if mesh is None else mesh.group())
        metrics = {"loss": loss, **topk_accuracy(logits, labels)}
        if mesh is not None:  # shares and equal-size row means -> global
            metrics = {"loss": all_reduce(loss, mesh.group()),
                       **{k: all_reduce(v, mesh.group()) / mesh.size()
                          for k, v in metrics.items() if k != "loss"}}
        return state, metrics

    return step


def make_eval_step(model: VideoClassifier, compute_dtype: torch.dtype = torch.float32):
    """``eval_step(batch) -> fp32 logits`` of the eval-mode model."""

    @torch.no_grad()
    def eval_step(batch: dict) -> torch.Tensor:
        model.eval()
        return model(normalize_clip(batch["clip"], dtype=compute_dtype)).float()

    return eval_step


def evaluate(eval_step, batches, ks=(1, 5), mesh=None) -> dict:
    """Masked (padding-aware) top-k over an eval split: rows whose ``valid``
    is False (the padded tail) are not counted. Under a ``data`` mesh each
    rank's ``batches`` are its rows; the counts are summed over the ranks,
    so the result is one device's exactly."""
    total = 0
    correct = {k: 0 for k in ks}
    for batch in batches:
        logits = eval_step(batch)
        maxk = min(max(ks), logits.shape[-1])
        match = logits.topk(maxk, dim=-1).indices == batch["label"][:, None].long()
        valid = batch.get("valid")
        keep = (valid.to(match.device).bool() if valid is not None
                else torch.ones(match.shape[0], dtype=torch.bool, device=match.device))
        total += int(keep.sum())
        for k in ks:
            correct[k] += int((match[:, :k].any(dim=1) & keep).sum())
    if mesh is not None:
        counts = all_reduce(torch.tensor([total] + [correct[k] for k in ks],
                                         dtype=torch.int64, device=_device_of(mesh)),
                            mesh.group())
        total, correct = int(counts[0]), {k: int(c) for k, c in zip(ks, counts[1:])}
    return {f"top{k}": (correct[k] / max(total, 1)) for k in ks}


def _device_of(mesh) -> torch.device:
    """Where the mesh's collectives take their tensors: the current card
    for NCCL, the CPU for gloo."""
    if dist.get_backend(mesh.group()) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
