"""Pipeline parallelism over the decoder's blocks (counterpart of the JAX
package's ``parallel/pp.py``).

On a ``{"pipe": n}`` mesh stage s holds decoder blocks ``[s*depth/n,
(s+1)*depth/n)``; the other blocks' params are empty on it (each block's
params are cut along dim 0: whole on its stage, nothing elsewhere), so the
param order stays the one-device order. The batch is whole on every stage,
as JAX's ``P()`` leaves it: every stage runs the encoder and the embedding
on it (the BatchNorm statistics move alike everywhere; only stage 0 keeps
the graph), stage 0 feeds the pipeline, and the last stage runs the pixel
head and the loss.

The schedule is GPipe's: the batch splits into ``n_micro`` microbatches,
every forward runs, then every backward, with ``collectives.send_to`` and
``recv_from`` between neighbours (their backward is the reverse transfer).
Each stage runs its microbatches' backwards in the same order, which is
what pairs the blocking sends and receives. Fill and drain run no blocks:
JAX runs its stage program on a zero buffer in those ticks only so that
every tick compiles to one program.

The encoder's gradient arises on stage 0 and the head's on the last stage:
the replicated params' gradients are summed over the ``pipe`` line
(``train/state.Shards.partial``), so every stage applies the same update.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .collectives import recv_from, send_to
from .shard import cut_param


def stage_blocks(depth: int, n_stages: int, stage: int) -> range:
    """The decoder blocks of ``stage``; ``depth`` must divide by
    ``n_stages`` (JAX's ``pipeline_apply`` error)."""
    if depth % n_stages:
        raise ValueError(f"depth={depth} not divisible by pipe={n_stages}")
    k = depth // n_stages
    return range(stage * k, (stage + 1) * k)


def shard_model_pp(model: nn.Module, mesh) -> None:
    """Keep this stage's blocks of ``model.decoder.blocks`` (in place): the
    params of every other block become empty, and the model records its
    stage's blocks (``pipe_blocks``)."""
    blocks = model.decoder.blocks
    own = stage_blocks(len(blocks), mesh.size("pipe"), mesh.index("pipe"))
    for i, blk in enumerate(blocks):
        for mod in list(blk.modules()):
            for name, p in list(mod.named_parameters(recurse=False)):
                cut_param(mod, name, 0, torch.arange(p.shape[0]) if i in own
                          else torch.zeros(0, dtype=torch.long))
    model.pipe_blocks = own


class Pipeline:
    """One GPipe pass of ``n_micro`` microbatches through this stage of
    ``mesh``'s ``pipe`` line: :meth:`forward`, then :meth:`backward`."""

    def __init__(self, mesh, n_micro: int):
        self.group, self.stage, self.n = (mesh.group("pipe"), mesh.index("pipe"),
                                          mesh.size("pipe"))
        self.n_micro = n_micro
        self.first, self.last = self.stage == 0, self.stage == self.n - 1

    def forward(self, run_stage: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor) -> torch.Tensor | None:
        """``run_stage`` on each microbatch: of ``x`` (the decoder's input
        ``[B, ...]``, on every stage; stage 0's in the graph) on stage 0, of
        what the previous stage sends elsewhere. Returns the last stage's
        outputs of the whole batch, None on the others."""
        B = x.shape[0]
        if B % self.n_micro:
            raise ValueError(f"batch={B} not divisible by n_micro={self.n_micro}")
        mb = B // self.n_micro
        self.x_in = x.detach().requires_grad_(x.requires_grad) if self.first else None
        self.ends = []
        for m in range(self.n_micro):
            h = (self.x_in[m * mb:(m + 1) * mb] if self.first else
                 recv_from((mb,) + tuple(x.shape[1:]), x.dtype, x.device, self.stage - 1,
                           self.group))
            y = run_stage(h)
            self.ends.append(y if self.last else send_to(y, self.stage + 1, self.group))
        return torch.cat(self.ends) if self.last else None

    def backward(self, grad: torch.Tensor | None = None) -> torch.Tensor | None:
        """Every microbatch's backward through this stage, accumulating the
        stage's params' ``.grad``: from ``grad`` (the gradient of the last
        stage's outputs) on the last stage, from what the next stage sends
        elsewhere. Returns the gradient of the decoder's input on stage 0."""
        grads = grad.chunk(self.n_micro) if self.last else [None] * self.n_micro
        for end, g in zip(self.ends, grads):
            torch.autograd.backward(end, g)
        self.ends = []
        return self.x_in.grad if self.first else None
