"""Train state and optimizer (the JAX package's ``train/state.py``, and the
transforms ``train/mae_engine.wrap_accum_and_skip`` stacks).

The JAX package keeps params, BatchNorm statistics and the optax state in
one immutable PyTree. Here the model module holds the params (fp32) and the
BatchNorm statistics (buffers, updated in place by the train-mode forward),
and an optimizer object holds its own state; :class:`TrainState` ties them
to the step count. The optimizer stack is optax's, transform by transform:

- :class:`AdamW` is ``optax.chain(clip_by_global_norm?, adamw(schedule))``
  per parameter group: weight decay falls on EVERY param of a group (BN and
  LN scales, position embeddings), as optax's ``adamw`` does; the learning
  rate is the group's schedule read at the count of updates applied so far
  (pre-increment), so the first update of a warm-up run has lr 0.
  ``torch.optim.AdamW`` does the arithmetic: its decoupled decay and ``eps``
  outside the square root are optax's math.
- Parameter groups are ``optax.multi_transform`` (the finetune's head and
  backbone learning rates): each inner chain sees only its own leaves, so
  each group is clipped by its OWN global norm. A frozen parameter (a
  ``False`` of ``trainable_mask``, optax's ``set_to_zero``) is left out of
  the optimizer: no update, no weight decay, no moments.
- :class:`ApplyIfFinite` is ``optax.apply_if_finite``: a non-finite gradient
  leaves params, moments and the count untouched.
- :class:`MultiSteps` is ``optax.MultiSteps``: the running mean of k
  gradients goes to the inner transform on every k-th call; params change
  only then. Unlike optax, whose accumulator keeps a NaN once it has seen
  one (``(1 - emit) * acc``), the accumulator restarts from zeros after
  every k-th call, so one non-finite microbatch skips one update, not all
  later ones.

Under a mesh that splits the params (``parallel/ep.py``, ``tp.py``,
``pp.py``) each rank holds its shard of some params and whole copies of the
rest; :class:`Shards` says which, and every ``update`` takes it: the global
norm sums the shards' squares over the model axis and counts a replicated
param once, and the finite check is agreed over the model axis, so every
rank clips and skips alike. ``MultiSteps`` accumulates shards as they are.

Each of the three has ``state_dict()``/``load_state_dict()`` over flat
``{name: tensor}`` entries (the moments, the count of updates, the skip and
accumulation counters), so an optimizer round-trips through the port's
``.pt`` checkpoints and a resumed run continues exactly. :func:`update_ema`
is pipeline A's teacher update over a ``{name: tensor}`` copy of the params.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import torch
from torch import nn

from ..parallel.collectives import all_reduce, all_reduce_grads
from ..utils import tracing


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup from 0 then cosine decay to ``min_lr``:
    ``optax.warmup_cosine_decay_schedule`` with the JAX package's guards."""
    if warmup_steps >= total_steps:
        warmup_steps = max(total_steps - 1, 0)
    warmup_steps = max(warmup_steps, 1)
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return base_lr * min(max(count, 0), warmup_steps) / warmup_steps
        t = min(count - warmup_steps, decay_steps)
        return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


@dataclass(frozen=True)
class Shards:
    """Where a rank's params lie on a mesh's model axis (``expert``,
    ``model`` or ``pipe``), in the order of the gradients they go with:
    ``own[i]`` is true where param i is this rank's shard (its experts, its
    heads' rows and columns, or a decoder block of its stage, empty on the
    other stages), whose gradient is this rank's alone; the others are
    replicated over ``group``. ``partial``: a replicated param's gradient
    is a part that ``group`` sums (a pipeline: the encoder's lies on the
    first stage, the pixel head's on the last); else every rank of the
    group computes it whole."""
    group: object
    own: tuple[bool, ...]
    partial: bool = False

    def part(self, lo: int, n: int) -> "Shards":
        """The flags of gradients ``lo .. lo+n-1`` (a parameter group)."""
        return Shards(self.group, self.own[lo:lo + n], self.partial)


def shards_of(params: Sequence[torch.Tensor], mesh) -> Shards | None:
    """The :class:`Shards` of ``params`` on ``mesh`` (None without a model
    axis): a param that ``parallel/shard.py`` cut carries its ``shard``."""
    axis = None if mesh is None else mesh.model_axis
    if axis is None:
        return None
    return Shards(mesh.group(axis), tuple(hasattr(p, "shard") for p in params),
                  axis == "pipe")


def global_norm(tensors: Sequence[torch.Tensor], shards: Shards | None = None) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all entries, fp32, on the
    device; with ``shards`` that of the whole gradient, every shard's
    squares summed over the model axis, a replicated tensor counted once."""
    if shards is None or not any(shards.own):
        return torch.linalg.vector_norm(torch.stack([t.float().norm() for t in tensors]))
    sq = [torch.stack([t.float().square().sum() for t, own in zip(tensors, shards.own)
                       if own == flag] or [tensors[0].new_zeros((), dtype=torch.float32)]
                      ).sum() for flag in (False, True)]
    return torch.sqrt(sq[0] + all_reduce(sq[1], shards.group))


def all_finite(tensors: Sequence[torch.Tensor], shards: Shards | None = None) -> bool:
    """Whether every entry is finite; with ``shards`` over the model axis's
    ranks, so that all take the same decision. The host waits for the
    device here (a ``host_syncs`` read, once an update)."""
    bad = (~torch.stack([torch.isfinite(t).all() for t in tensors]).all()).float()
    if shards is not None:
        bad = all_reduce(bad, shards.group, op="max")
    return not bool(tracing.host_read(bad))


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip)?, adamw(learning_rate,
    b1, b2, eps=1e-8, weight_decay))`` over ``params``, or, when
    ``params`` holds group dicts ``{"name", "params", "lr"}``, one such chain
    per group (``optax.multi_transform``: clipped by the group's own norm, at
    the group's learning rate). ``params`` (all groups, in order) are what
    :meth:`update` takes gradients for."""

    def __init__(self, params, learning_rate: float | Callable[[int], float] | None = None,
                 weight_decay: float = 0.05, grad_clip: float | None = None,
                 betas: tuple[float, float] = (0.9, 0.999)):
        params = list(params)
        if params and isinstance(params[0], dict):
            groups = [g for g in params if g["params"]]
        else:
            groups = [{"name": "train", "params": params, "lr": learning_rate}]
        self.names = [g["name"] for g in groups]
        self.schedules = [g["lr"] if callable(g["lr"]) else (lambda _, lr=g["lr"]: lr)
                          for g in groups]
        self.sizes = [len(g["params"]) for g in groups]
        self.params = [p for g in groups for p in g["params"]]
        self.grad_clip = grad_clip
        self.count = 0  # updates applied
        self.opt = torch.optim.AdamW([{"params": list(g["params"])} for g in groups],
                                     lr=0.0, betas=tuple(betas), eps=1e-8,
                                     weight_decay=weight_decay)

    def update(self, grads: Sequence[torch.Tensor], shards: Shards | None = None) -> bool:
        grads, lo = list(grads), 0
        for pg, n, schedule in zip(self.opt.param_groups, self.sizes, self.schedules):
            if self.grad_clip is not None and self.grad_clip > 0:
                norm = global_norm(grads[lo:lo + n], None if shards is None
                                   else shards.part(lo, n))
                factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                     self.grad_clip / norm)
                grads[lo:lo + n] = [g * factor for g in grads[lo:lo + n]]
            pg["lr"] = float(schedule(self.count))
            lo += n
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def state_dict(self) -> dict[str, torch.Tensor]:
        """``count`` and, for the i-th param, ``{i}.exp_avg``,
        ``{i}.exp_avg_sq`` and ``{i}.step`` once it has been updated."""
        out = {"count": torch.tensor(self.count)}
        for i, p in enumerate(self.params):
            for key, value in self.opt.state.get(p, {}).items():
                out[f"{i}.{key}"] = value
        return out

    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        self.count = int(sd["count"])
        for i, p in enumerate(self.params):
            st = {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith(f"{i}.")}
            if st:
                # torch keeps ``step`` on the host, the moments beside the param
                self.opt.state[p] = {k: v.clone() if k == "step" else v.to(p.device, p.dtype)
                                     for k, v in st.items()}


class ApplyIfFinite:
    """``optax.apply_if_finite(inner, max_consecutive_errors)``."""

    def __init__(self, inner, max_consecutive_errors: int = 10_000):
        self.inner = inner
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.total_notfinite = 0

    def update(self, grads: Sequence[torch.Tensor], shards: Shards | None = None) -> bool:
        finite = all_finite(grads, shards)
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        if finite or self.notfinite_count > self.max_consecutive_errors:
            return self.inner.update(grads, shards)
        return False

    def state_dict(self) -> dict[str, torch.Tensor]:
        return {"notfinite_count": torch.tensor(self.notfinite_count),
                "total_notfinite": torch.tensor(self.total_notfinite),
                **{f"inner.{k}": v for k, v in self.inner.state_dict().items()}}

    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        self.notfinite_count = int(sd["notfinite_count"])
        self.total_notfinite = int(sd["total_notfinite"])
        self.inner.load_state_dict(_inner(sd))


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` with the gradient
    mean (Welford's running mean, as optax), restarting after each update."""

    def __init__(self, inner, every_k: int):
        self.inner = inner
        self.every_k = every_k
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None

    def update(self, grads: Sequence[torch.Tensor], shards: Shards | None = None) -> bool:
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        applied = self.inner.update(self.acc, shards)
        self.mini_step = 0
        for a in self.acc:
            a.zero_()
        return applied

    def state_dict(self) -> dict[str, torch.Tensor]:
        out = {"mini_step": torch.tensor(self.mini_step)}
        for i, a in enumerate(self.acc or []):
            out[f"acc.{i}"] = a
        return {**out, **{f"inner.{k}": v for k, v in self.inner.state_dict().items()}}

    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        self.mini_step = int(sd["mini_step"])
        params = adamw_of(self).params
        acc = [sd.get(f"acc.{i}") for i in range(len(params))]
        self.acc = (None if acc[0] is None
                    else [a.to(p.device, p.dtype).clone() for a, p in zip(acc, params)])
        self.inner.load_state_dict(_inner(sd))


def _inner(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k[len("inner."):]: v for k, v in sd.items() if k.startswith("inner.")}


def make_optimizer(params, learning_rate: float | Callable[[int], float],
                   weight_decay: float = 0.05, grad_clip: float | None = None,
                   betas: tuple[float, float] = (0.9, 0.999),
                   trainable_mask: Sequence[bool] | None = None) -> AdamW:
    """AdamW + opt-in global-norm clip (None: no clipping; pipeline B never
    clips). ``betas`` are optax's ``b1, b2`` (pipeline C: 0.9, 0.95).
    ``trainable_mask`` (one bool per param of ``params``): the ``False``
    ones are frozen, left out of the optimizer."""
    params = list(params)
    if trainable_mask is not None:
        params = [p for p, t in zip(params, trainable_mask, strict=True) if t]
    return AdamW(params, learning_rate, weight_decay=weight_decay, grad_clip=grad_clip,
                 betas=betas)


def adamw_of(tx) -> AdamW:
    """The :class:`AdamW` at the bottom of a wrapped optimizer."""
    while not isinstance(tx, AdamW):
        tx = tx.inner
    return tx


@dataclass
class TrainState:
    """``step`` counts train-step calls (skipped or not, as the JAX state's
    ``step``); ``model`` holds params and BatchNorm statistics; ``tx`` is the
    optimizer over ``model``'s params; ``ema`` (pipeline A's teacher) maps
    each param's name to its moving average."""
    step: int
    model: nn.Module
    tx: object
    ema: dict[str, torch.Tensor] | None = None

    @property
    def params(self) -> list[torch.Tensor]:
        return adamw_of(self.tx).params


def create_train_state(model: nn.Module, tx,
                       ema: Mapping[str, torch.Tensor] | None = None) -> TrainState:
    return TrainState(step=0, model=model, tx=tx, ema=None if ema is None else dict(ema))


def apply_updates(state: TrainState, grads: Sequence[torch.Tensor], group=None,
                  shards: Shards | None = None) -> bool:
    """One optimizer call with ``grads`` (aligned with ``state.params``);
    the step count always advances. Returns whether params changed.

    With ``group`` (the axis that splits the batch: ``data`` or ``seq``)
    ``grads`` are each rank's gradients of its share of the loss: they are
    summed over the group IN PLACE first, so the global norm, clipping, the
    finite check and the accumulation all see the global gradient and every
    rank takes the same clip and skip decisions. The ranks of a ``data``
    line hold the same shard of a sharded param, so its gradient is summed
    there too. With ``shards`` the replicated params' partial gradients
    (``Shards.partial``) are summed over the model axis as well; a shard's
    gradient is its rank's own and is not summed there."""
    if group is not None:
        all_reduce_grads(grads, group)
    if shards is not None and shards.partial:
        all_reduce_grads([g for g, own in zip(grads, shards.own) if not own], shards.group)
    applied = state.tx.update(grads, shards)
    state.step += 1
    return applied


@torch.no_grad()
def update_ema(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               momentum: float) -> None:
    """EMA teacher update in place, ``e = m*e + (1-m)*p`` for every param
    (ref: src/train_ssl.py:36-39)."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, momentum)
    torch._foreach_add_(e, [params[n].to(ema[n].dtype) * (1.0 - momentum) for n in names])
