"""Expert parallelism for the opt-in MoE decoder MLP (counterpart of the
JAX package's ``parallel/ep.py``).

On a ``{"data": dp, "expert": ep}`` mesh the rank at expert index e holds
experts ``[e*E/ep, (e+1)*E/ep)`` of every ``layers.MoeMlp`` bank (``w1``,
``b1``, ``w2``, ``b2``), and AdamW moments for those experts only. The
batch is split over ``data`` and whole over ``expert``, as JAX's
``P("data")`` leaves it, so the ranks of an expert line hold the same
tokens: each computes the routing, the capacity and the dispatch as one
device would, feeds its own experts their slots (the dispatch einsum on
its experts alone), and the ``[E, G*C, D]`` outputs are reassembled over
the line for the combine (:func:`collectives.all_gather_own`, whose
backward keeps the rank's own experts' block of the gradient: every rank
of the line computes the same downstream). The bank's gradient is then
summed over the ``data`` line that shares the rank's experts, like every
other gradient, and nothing is counted twice.

JAX keeps the active mesh in a process-global (``set_ep_mesh``); here
:func:`shard_model_ep` gives each ``MoeMlp`` its line's group and expert
range, and the module applies its experts itself (JAX's
``expert_parallel_apply``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.layers import MoeMlp
from .shard import cut_param

BANK = ("w1", "b1", "w2", "b2")


def expert_range(num_experts: int, ep: int, index: int) -> tuple[int, int]:
    """The experts ``[lo, hi)`` that the rank at expert index ``index``
    holds; ``num_experts`` must divide by ``ep``."""
    if num_experts % ep:
        raise ValueError(f"{num_experts} experts do not divide over {ep} expert ranks")
    k = num_experts // ep
    return index * k, (index + 1) * k


def shard_model_ep(model: nn.Module, mesh) -> None:
    """Cut every ``MoeMlp`` bank of ``model`` to this rank's experts (in
    place), and give the module its ``expert`` line's group."""
    ep, e = mesh.size("expert"), mesh.index("expert")
    for m in model.modules():
        if isinstance(m, MoeMlp):
            lo, hi = expert_range(m.num_experts, ep, e)
            for name in BANK:
                cut_param(m, name, 0, torch.arange(lo, hi))
            m.expert_group = mesh.group("expert")
            m.expert_lo = lo


def count_bank_sharded(model: nn.Module) -> tuple[int, int]:
    """``(bank leaves cut over 'expert', all param leaves)`` for the
    entry's log line (JAX's ``count_bank_sharded``)."""
    n_sh = n_tot = 0
    for m in model.modules():
        for name, p in m.named_parameters(recurse=False):
            n_tot += 1
            n_sh += isinstance(m, MoeMlp) and name in BANK and hasattr(p, "shard")
    return n_sh, n_tot
