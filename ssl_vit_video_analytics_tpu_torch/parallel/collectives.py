"""The collectives XLA inserts for the JAX package's meshes, written out:
a differentiable all-reduce and all-gather, and the gradient reduction.

Convention: under a mesh, each rank's loss is its SHARE of the global loss
(its rows' or frames' sum over the global count), so the global loss is the
sum of the shares and its gradient the sum of the ranks' gradients
(:func:`all_reduce_grads`). A value every rank uses is built with
:func:`all_reduce_sum` or :func:`all_gather`, whose backward sums the
gradients that every rank's share sends into it: the backward of an
all-reduce-sum is an all-reduce-sum, the backward of an all-gather a
reduce-scatter. A term that every rank computes whole from gathered
values enters each share divided by the mesh size.

Model sharding adds the transposes where every rank of a group computes
the same downstream from a value it holds only a part of (its experts'
outputs, its heads' attention), so that the downstream's gradient is this
rank's already and is not to be summed: :func:`all_gather_own`, whose
backward takes this rank's block of the gradient; Megatron's ``f``
(:func:`copy_to_group`: identity forward, all-reduce backward) and ``g``
(:func:`reduce_from_group`: all-reduce forward, identity backward); and
the pipeline's point-to-point pair (:func:`send_to`, :func:`recv_from`),
whose backward is the reverse transfer.

``torch.distributed.nn.functional`` is not used: it is deprecated.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor forms (the old names warn); older torch has
# only the old names
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, differentiable."""
    return _AllReduceSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        # the collective gathers along dim 0 of contiguous buffers: this
        # copy is the one it needs (none for a contiguous x gathered on 0);
        # the result is a view with ``dim`` put back
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        _gather_into(out, x, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.movedim(ctx.dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        _reduce_scatter(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (a strided
    view for ``dim`` > 0), differentiable: its backward reduce-scatters the
    gradient."""
    return _AllGather.apply(x, dim, group)


class _AllGatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def all_gather_own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, differentiable for a downstream that every rank of the group
    computes alike: its backward is this rank's block of the gradient, not
    the group's sum of it (which :func:`all_gather` takes)."""
    return _AllGatherOwn.apply(x, dim, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is, whose gradient is summed over the
    group (each rank's part of a column-parallel layer sends back its
    share of the input's gradient)."""
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: the sum of ``x`` over the group, whose gradient
    goes back to each rank as it is (every rank computes the same
    downstream of the sum)."""
    return _ReduceFromGroup.apply(x, group)


class _SendTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, peer, group):
        ctx.peer, ctx.group, ctx.shape = peer, group, x.shape
        dist.send(x.contiguous(), dist.get_global_rank(group, peer), group=group)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        g = _g.new_empty(ctx.shape)
        dist.recv(g, dist.get_global_rank(ctx.group, ctx.peer), group=ctx.group)
        return g, None, None


def send_to(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``x`` to ``peer`` (its rank in ``group``). Returns a scalar
    token: backward from it receives ``x``'s gradient from ``peer`` (what
    its :func:`recv_from` sends back) and carries it into ``x``'s graph."""
    return _SendTo.apply(x, peer, group)


class _RecvFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, shape, peer, group):
        ctx.peer, ctx.group = peer, group
        x = anchor.new_empty(shape)
        dist.recv(x, dist.get_global_rank(group, peer), group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), dist.get_global_rank(ctx.group, ctx.peer), group=ctx.group)
        return None, None, None, None


def recv_from(shape, dtype: torch.dtype, device, peer: int, group) -> torch.Tensor:
    """A tensor of ``shape`` received from ``peer`` (its rank in
    ``group``), in the graph: its gradient is sent back to ``peer`` in the
    backward."""
    anchor = torch.zeros((), dtype=dtype, device=device, requires_grad=True)
    return _RecvFrom.apply(anchor, tuple(shape), peer, group)


@torch.no_grad()
def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced over the group (``sum`` or ``max``), no
    gradient."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return y


@torch.no_grad()
def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, no gradient."""
    x = x.detach().movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group=group)
    return out.movedim(0, dim)


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor], group, op: str = "sum") -> None:
    """Reduce ``tensors`` over the group in place (``sum`` or ``max``): one
    flat buffer per dtype, one all-reduce each."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=red, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_reduce_grads(grads: Sequence[torch.Tensor], group) -> None:
    """Sum ``grads`` over the group in place (:func:`all_reduce_flat`)."""
    all_reduce_flat(grads, group)
