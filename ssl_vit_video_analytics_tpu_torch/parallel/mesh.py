"""Process groups as mesh axes (counterpart of the JAX package's
``parallel/mesh.py``).

JAX builds a ``Mesh`` over devices of one program; here every card runs its
own process, launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` in the environment). A :class:`Mesh` lays the first ``n``
ranks out over one or more named axes in row-major order, as JAX's
``np.asarray(devices).reshape(sizes)`` does: on ``{"data": 2, "expert":
4}`` rank r sits at ``(r // 4, r % 4)``. Each axis has a process group for
every line of ranks along it; a rank holds the groups of its own lines.

- ``data``: each rank holds a contiguous block of the batch's rows, params
  replicated; gradients and batch statistics are summed over the group.
- ``seq``: each rank holds a contiguous block of every clip's frames (the
  long-clip decoder's tokens); attention gathers K/V over the group
  (``parallel/sp.py``).
- ``client``: each rank runs a contiguous block of FedAvg's clients; the
  aggregate is an all-reduce (``federated/core.py``).
- ``expert``: each rank holds a block of every MoE bank's experts
  (``parallel/ep.py``); the batch is replicated over it.
- ``model``: each rank holds a block of every attention's heads and of
  every dense MLP's hidden units (``parallel/tp.py``); the batch is
  replicated over it.
- ``pipe``: each rank holds a contiguous block of the decoder's blocks and
  runs them on the whole batch, microbatch by microbatch
  (``parallel/pp.py``).

A rank outside the mesh (``index()`` -1) takes no part in it.
"""
from __future__ import annotations

import contextlib
import itertools
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

AXES = ("data", "seq", "client", "expert", "model", "pipe")
# the axes that split the batch (FedAvg's clients for the client axis), in
# the order a mesh is searched for one
SPLIT_AXES = ("seq", "data", "client")
# the axes that split the model's params
MODEL_AXES = ("expert", "model", "pipe")


def env_rank() -> int:
    """This process's rank as the launcher set it (0 without a launcher)."""
    return int(os.environ.get("RANK", 0))


def local_rank() -> int:
    """The card of this process on its host (``LOCAL_RANK``, 0 without a
    launcher)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device: torch.device | str) -> bool:
    """Join the launcher's process group: NCCL when ``device`` is a card
    (made this process's current card), gloo on the CPU, then a barrier, so
    that a backend that cannot come up fails here and not at the first
    collective. Without the launcher's environment nothing is set up.
    Idempotent. Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                            rank=env_rank(), world_size=int(os.environ["WORLD_SIZE"]),
                            device_id=device if cuda else None)
    dist.barrier()
    return True


@contextlib.contextmanager
def process_group_scope():
    """Run an entry's body, then tear the process group down. No barrier:
    a rank outside the mesh leaves early, and the mesh's last collective
    (the barrier after a checkpoint) is in the body."""
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0 (or no group): the process that writes logs, CSVs and
    checkpoints."""
    return rank() == 0 if dist.is_initialized() else env_rank() == 0


def barrier(mesh: "Mesh | None" = None) -> None:
    """Wait for the mesh's ranks (every rank without one)."""
    if mesh is not None:
        dist.barrier(group=mesh.group())
    elif dist.is_initialized():
        dist.barrier()


def mesh_repr(axes: dict[str, int]) -> str:
    """How a mesh prints (the entries' log): ``Mesh('data': 2, 'expert': 4)``."""
    return "Mesh(" + ", ".join(f"{a!r}: {n}" for a, n in axes.items()) + ")"


@dataclass(frozen=True)
class Mesh:
    """Named axes over the first ``prod(sizes)`` ranks: ``shape`` is
    ``((axis, size), ...)`` in order, ``coords`` this rank's position
    (None outside the mesh), ``lines`` the process group of this rank's
    line along each axis and ``whole`` that of every rank of the mesh (None
    in a mesh made without process groups)."""

    shape: tuple[tuple[str, int], ...]
    coords: tuple[int, ...] | None
    lines: tuple = ()
    whole: object = None

    def __repr__(self) -> str:
        return mesh_repr(dict(self.shape))

    @property
    def axes(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.shape)

    @property
    def member(self) -> bool:
        return self.coords is not None

    def _at(self, axis: str) -> int:
        if axis not in self.axes:
            raise KeyError(f"{self!r} has no {axis!r} axis")
        return self.axes.index(axis)

    def size(self, axis: str | None = None) -> int:
        """Ranks along ``axis`` (None: in the whole mesh)."""
        if axis is None:
            n = 1
            for _, s in self.shape:
                n *= s
            return n
        return self.shape[self._at(axis)][1]

    def index(self, axis: str | None = None) -> int:
        """This rank's position along ``axis`` (None: its rank in the whole
        mesh, row-major); -1 outside the mesh."""
        if self.coords is None:
            return -1
        if axis is not None:
            return self.coords[self._at(axis)]
        r = 0
        for (_, s), c in zip(self.shape, self.coords):
            r = r * s + c
        return r

    def group(self, axis: str | None = None):
        """The process group of this rank's line along ``axis`` (None: of the
        whole mesh)."""
        return self.whole if axis is None else self.lines[self._at(axis)]

    @property
    def split_axis(self) -> str | None:
        """The axis that splits the batch (``seq``, ``data`` or ``client``),
        or None: the batch is whole on every rank (a ``pipe`` mesh)."""
        return next((a for a in SPLIT_AXES if a in self.axes), None)

    @property
    def batch_group(self):
        """The group over which the batch is split: batch statistics, the
        masked counts of the loss and the gradients are summed over it (None:
        the batch is whole on every rank)."""
        axis = self.split_axis
        return None if axis is None else self.group(axis)

    @property
    def model_axis(self) -> str | None:
        """The axis that splits the params (``expert``, ``model`` or
        ``pipe``), or None."""
        return next((a for a in MODEL_AXES if a in self.axes), None)

    def batch_part(self, batch_size: int, frames: int) -> tuple[slice, slice]:
        """``(rows, frames)`` of a global batch of ``batch_size`` clips of
        ``frames`` frames that this rank holds."""
        whole = slice(None)
        if self.split_axis == "seq":
            return whole, self.block(frames)
        return self.block(batch_size), whole

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` items (rows, frames,
        clients) along the split axis (all ``n`` when the batch is whole);
        ``n`` must divide evenly."""
        axis = self.split_axis
        if axis is None:
            return slice(0, n)
        size = self.size(axis)
        if n % size:
            raise ValueError(f"{n} items do not divide over the {axis} axis of {size}")
        k, i = n // size, self.index(axis)
        return slice(i * k, (i + 1) * k)


def make_mesh(axes: dict[str, int]) -> Mesh:
    """A mesh ``{axis: size, ...}`` over ranks ``0..prod(sizes)-1`` of the
    initialized world, laid out row-major in the order of ``axes``. Every
    rank of the world must call it: each line's group is made
    collectively, every rank making every group in the same order."""
    if not axes:
        raise ValueError("a mesh needs at least one axis")
    for axis in axes:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} (expected one of {AXES})")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_distributed under torchrun)")
    world = dist.get_world_size()
    names, sizes = list(axes), [int(n) for n in axes.values()]
    total = 1
    for n in sizes:
        if n < 1:
            raise ValueError(f"mesh {axes}: sizes must be at least 1")
        total *= n
    if total > world:
        raise ValueError(f"mesh {axes} needs {total} ranks, have {world}")

    made: dict[tuple[int, ...], object] = {}

    def group_of(ranks: list[int]):
        key = tuple(ranks)
        if key not in made:
            made[key] = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
        return made[key]

    whole = group_of(list(range(total)))
    r = dist.get_rank()
    coords = None
    if r < total:
        coords, rest = [], r
        for n in reversed(sizes):
            coords.append(rest % n)
            rest //= n
        coords = tuple(reversed(coords))
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    lines = [whole if len(sizes) == 1 else None for _ in sizes]
    if len(sizes) > 1:
        for a in range(len(sizes)):
            others = [range(n) if i != a else range(1) for i, n in enumerate(sizes)]
            for pos in itertools.product(*others):
                base = sum(p * s for p, s in zip(pos, strides))
                ranks = [base + j * strides[a] for j in range(sizes[a])]
                g = group_of(ranks)
                if r in ranks:
                    lines[a] = g
    return Mesh(tuple(zip(names, sizes)), coords, tuple(lines), whole)


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's part of a global batch: its rows of every entry (a
    ``data`` axis; whole over the other axes, as JAX's ``P("data")``), its
    frames of ``clip`` with every other entry whole (``seq``), or all of it
    (no axis splits the batch: a ``pipe`` mesh)."""
    if mesh is None or mesh.split_axis is None:
        return batch
    if mesh.split_axis == "seq":
        return {k: (v[:, mesh.block(v.shape[1])] if k == "clip" else v)
                for k, v in batch.items()}
    return {k: v[mesh.block(v.shape[0])] for k, v in batch.items()}


def global_clip_shape(mesh: Mesh | None, batch: int, frames: int) -> tuple[int, int, int]:
    """``(clips, frames, first frame)`` of the global batch of which this
    rank holds ``batch`` clips of ``frames`` frames."""
    axis = None if mesh is None else mesh.split_axis
    if axis is None:
        return batch, frames, 0
    if axis == "seq":
        return batch, frames * mesh.size(axis), mesh.index(axis) * frames
    return batch * mesh.size(axis), frames, 0


def local_part(x: torch.Tensor | None, mesh: Mesh | None, frames: int | None = None):
    """This rank's part of a draw made for the global batch: ``x`` has the
    clips on dim 0 and, when ``frames`` is given, ``frames`` blocks of
    entries in frame order on dim 1 (a tube mask ``[B, T, L]``, a token
    mask ``[B, T*P]``). ``data``: its clips; ``seq``: its frames' entries
    of every clip (a per-clip draw stays whole); no split axis: all of
    it."""
    if mesh is None or x is None or mesh.split_axis is None:
        return x
    if mesh.split_axis != "seq":
        return x[mesh.block(x.shape[0])]
    if frames is None or x.dim() < 2:
        return x
    B, rest = x.shape[0], tuple(x.shape[2:])
    y = x.reshape((B, frames, x.shape[1] // frames) + rest)[:, mesh.block(frames)]
    return y.reshape((B, -1) + rest)


def local_draws(tree, mesh: Mesh | None, batch: int, frames: int):
    """This rank's part of per-frame draws made for the global batch:
    every tensor of ``tree`` (nested lists and tuples, None kept) is
    ``[batch * frames]`` in (clip, frame) order, as stochastic-depth
    decisions are; the rank keeps its clips' (``data``) or frames'
    (``seq``) entries, or all of them (no split axis)."""
    if mesh is None or tree is None or mesh.split_axis is None:
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_draws(t, mesh, batch, frames) for t in tree)
    x = tree.reshape(batch, frames)
    x = x[:, mesh.block(frames)] if mesh.split_axis == "seq" else x[mesh.block(batch)]
    return x.reshape(-1)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, mesh: Mesh | None) -> None:
    """Make the replicas identical: every param and buffer from the mesh's
    first rank (JAX's ``place_state`` replicates the state; a sharded
    layout is cut from the whole state afterwards)."""
    if mesh is None:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group())
