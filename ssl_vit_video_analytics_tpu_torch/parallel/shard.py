"""Params cut over a mesh's model axis, and the whole state put back
together (the port's counterpart of JAX's ``device_put`` with a sharded
``PartitionSpec``, and of reading a sharded array whole).

A param that a rank holds only part of carries a :class:`Shard`: the
entries along ``dim`` of the whole tensor that it holds, in its order.
Over the axis's ranks the parts cover the whole dim exactly once. That one
form serves every layout of the port: a block of experts (``expert``), the
rows ``[q_r | k_r | v_r]`` of a block of heads and their columns of the
projection (``model``), and a decoder block whole on its stage and empty on
the others (``pipe``). A one-device module keeps its params and names; the
cut replaces each param by its part, with the same name, so that the param
order, and with it the optimizer's, is the one-device order.

:func:`full_state_dict` gathers a model's state (and any tensors laid out
as its params, the AdamW moments) into the one-device layout: the file a
checkpoint writes is the one a single device writes. :func:`load_full`
cuts a whole state onto this rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
from torch import nn

from .collectives import all_gather_cat


@dataclass(frozen=True)
class Shard:
    """This rank's entries ``index`` (a CPU LongTensor) along ``dim`` of a
    whole tensor of ``full`` entries there."""
    dim: int
    index: torch.Tensor
    full: int

    def cut(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``whole``."""
        return whole.index_select(self.dim, self.index.to(whole.device))


def cut_param(module: nn.Module, name: str, dim: int, index) -> nn.Parameter:
    """Replace ``module``'s param ``name`` by its entries ``index`` along
    ``dim`` (a new leaf, marked with its :class:`Shard`)."""
    whole = getattr(module, name)
    shard = Shard(dim, torch.as_tensor(index, dtype=torch.long).reshape(-1).cpu(),
                  whole.shape[dim])
    p = nn.Parameter(shard.cut(whole.detach()).clone(), requires_grad=whole.requires_grad)
    p.shard = shard
    setattr(module, name, p)
    return p


@torch.no_grad()
def gather_shard(t: torch.Tensor, shard: Shard, group) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's part, on every rank of
    ``group`` (the parts may differ in size: each is padded to the whole
    length for the gather)."""
    dim, full = shard.dim, shard.full
    idx = torch.full((full,), -1, dtype=torch.long, device=t.device)
    idx[:len(shard.index)] = shard.index.to(t.device)
    idxs = all_gather_cat(idx[None], group)                       # [n, full]
    shape = list(t.shape)
    shape[dim] = full
    buf = t.new_zeros(shape)
    buf.narrow(dim, 0, t.shape[dim]).copy_(t)
    bufs = all_gather_cat(buf[None], group)                       # [n, ...]
    out = t.new_zeros(shape)
    for r in range(bufs.shape[0]):
        k = int((idxs[r] >= 0).sum())
        out.index_copy_(dim, idxs[r, :k], bufs[r].narrow(dim, 0, k))
    return out


def shards_by_name(model: nn.Module) -> dict[str, Shard]:
    return {n: p.shard for n, p in model.named_parameters() if hasattr(p, "shard")}


def full_state_dict(model: nn.Module, mesh, tensors: Mapping[str, torch.Tensor] | None = None,
                    like: Mapping[str, str] | None = None) -> dict[str, torch.Tensor]:
    """``tensors`` (default: ``model.state_dict()``) in the one-device
    layout: every tensor laid out as a cut param is gathered over the
    mesh's model axis (collective: every rank of the mesh calls it, in the
    same order). ``like`` maps a key of ``tensors`` to the param whose
    layout it has (default: the key itself)."""
    tensors = model.state_dict() if tensors is None else tensors
    shards = shards_by_name(model)
    axis = None if mesh is None else mesh.model_axis
    out = {}
    for key, t in tensors.items():
        shard = shards.get((like or {}).get(key, key))
        out[key] = (t if shard is None or axis is None
                    else gather_shard(t, shard, mesh.group(axis)))
    return out


def local_state_dict(model: nn.Module, full: Mapping[str, torch.Tensor],
                     like: Mapping[str, str] | None = None) -> dict[str, torch.Tensor]:
    """This rank's part of a one-device state ``full``: every tensor laid
    out as a cut param is cut as it is."""
    shards = shards_by_name(model)
    out = {}
    for key, t in full.items():
        shard = shards.get((like or {}).get(key, key))
        out[key] = t if shard is None else shard.cut(t)
    return out


def load_full(model: nn.Module, full: Mapping[str, torch.Tensor]) -> None:
    """Load a one-device state dict into a cut model (strict)."""
    model.load_state_dict(local_state_dict(model, full))


def optimizer_state_like(model: nn.Module, params, sd: Mapping[str, torch.Tensor]
                         ) -> dict[str, str]:
    """For each key of an optimizer's state dict ``sd`` (``train/state``:
    ``{i}.exp_avg``, ``acc.{i}``, under ``inner.`` prefixes) that holds a
    tensor laid out as param i of ``params``, that param's name."""
    names = {id(p): n for n, p in model.named_parameters()}
    by_index = {i: names[id(p)] for i, p in enumerate(params)}
    out = {}
    for key, t in sd.items():
        parts = key.split(".")
        for j, part in enumerate(parts):
            if part.isdigit() and (j + 1 < len(parts) or (j > 0 and parts[j - 1] == "acc")):
                if t.dim() > 0:
                    out[key] = by_index[int(part)]
                break
    return out


def shard_model(model: nn.Module, mesh) -> None:
    """Cut ``model`` (whole and alike on every rank) over ``mesh``'s model
    axis in place: its expert banks (``expert``), its attention heads and
    MLP hidden units (``model``) or its decoder's blocks (``pipe``). A mesh
    without a model axis leaves it whole."""
    axis = None if mesh is None else mesh.model_axis
    if axis == "expert":
        from .ep import shard_model_ep
        shard_model_ep(model, mesh)
    elif axis == "model":
        from .tp import shard_model_tp
        shard_model_tp(model, mesh)
    elif axis == "pipe":
        from .pp import shard_model_pp
        shard_model_pp(model, mesh)
