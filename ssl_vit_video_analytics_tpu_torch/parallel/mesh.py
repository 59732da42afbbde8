"""Process groups as mesh axes (counterpart of the JAX package's
``parallel/mesh.py``).

JAX builds a ``Mesh`` over devices of one program; here every card runs its
own process, launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` in the environment). A :class:`Mesh` is one axis over the
first ``n`` ranks, as JAX takes ``jax.devices()[:n]``:

- ``data``: each rank holds a contiguous block of the batch's rows, params
  replicated; gradients and batch statistics are summed over the group.
- ``seq``: each rank holds a contiguous block of every clip's frames (the
  long-clip decoder's tokens); attention gathers K/V over the group
  (``parallel/sp.py``).
- ``client``: each rank runs a contiguous block of FedAvg's clients; the
  aggregate is an all-reduce (``federated/core.py``).

A rank outside the mesh (``index`` -1) takes no part in it.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

AXES = ("data", "seq", "client")


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
        dist.barrier(group=mesh.group)
    elif dist.is_initialized():
        dist.barrier()


def mesh_repr(axis: str, n: int) -> str:
    """How a mesh of ``n`` ranks over ``axis`` prints (the entries' log)."""
    return f"Mesh({axis!r}: {n})"


@dataclass(frozen=True)
class Mesh:
    """One mesh axis: ``size`` ranks (the first ``size`` of the world),
    this rank's ``index`` in it (-1 outside) and their process ``group``."""

    axis: str
    size: int
    index: int
    group: object

    def __repr__(self) -> str:
        return mesh_repr(self.axis, self.size)

    @property
    def member(self) -> bool:
        return self.index >= 0

    def batch_part(self, batch_size: int, frames: int) -> tuple[slice, slice]:
        """``(rows, frames)`` of a global batch of ``batch_size`` clips of
        ``frames`` frames that this rank holds."""
        whole = slice(None)
        if self.axis == "seq":
            return whole, self.block(frames)
        return self.block(batch_size), whole

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` items (rows, frames,
        clients); ``n`` must divide evenly."""
        if n % self.size:
            raise ValueError(f"{n} items do not divide over the {self.axis} axis of "
                             f"{self.size}")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


def make_mesh(axes: dict[str, int]) -> Mesh:
    """A one-axis mesh ``{"data" | "seq" | "client": n}`` over ranks
    ``0..n-1`` of the initialized world. Every rank of the world must call
    it (a sub-group is made collectively)."""
    if len(axes) != 1:
        raise ValueError(f"one mesh axis at a time, got {axes} (model sharding over "
                         "several axes is ROADMAP item 15c)")
    (axis, n), = axes.items()
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r} (expected one of {AXES})")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_distributed under torchrun)")
    world = dist.get_world_size()
    n = int(n)
    if not 1 <= n <= world:
        raise ValueError(f"mesh {axes} needs {n} ranks, have {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    r = dist.get_rank()
    return Mesh(axis, n, r if r < n else -1, group)


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's part of a global batch: its rows of every entry
    (``data``), or its frames of ``clip`` with every other entry whole
    (``seq``)."""
    if mesh is None:
        return batch
    if mesh.axis == "seq":
        return {k: (v[:, mesh.block(v.shape[1])] if k == "clip" else v)
                for k, v in batch.items()}
    return {k: v[mesh.block(v.shape[0])] for k, v in batch.items()}


def global_clip_shape(mesh: Mesh | None, batch: int, frames: int) -> tuple[int, int, int]:
    """``(clips, frames, first frame)`` of the global batch of which this
    rank holds ``batch`` clips of ``frames`` frames."""
    if mesh is None:
        return batch, frames, 0
    if mesh.axis == "seq":
        return batch, frames * mesh.size, mesh.index * frames
    return batch * mesh.size, frames, 0


def local_part(x: torch.Tensor | None, mesh: Mesh | None, frames: int | None = None):
    """This rank's part of a draw made for the global batch: ``x`` has the
    clips on dim 0 and, when ``frames`` is given, ``frames`` blocks of
    entries in frame order on dim 1 (a tube mask ``[B, T, L]``, a token
    mask ``[B, T*P]``). ``data``: its clips; ``seq``: its frames' entries
    of every clip (a per-clip draw stays whole)."""
    if mesh is None or x is None:
        return x
    if mesh.axis != "seq":
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
    (``seq``) entries."""
    if mesh is None or tree is None:
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_draws(t, mesh, batch, frames) for t in tree)
    x = tree.reshape(batch, frames)
    x = x[:, mesh.block(frames)] if mesh.axis == "seq" else x[mesh.block(batch)]
    return x.reshape(-1)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, mesh: Mesh | None) -> None:
    """Make the replicas identical: every param and buffer from the mesh's
    first rank (JAX's ``place_state`` replicates the state)."""
    if mesh is None:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
