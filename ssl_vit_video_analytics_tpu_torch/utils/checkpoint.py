"""Checkpoints as torch files (counterpart of the JAX package's
``utils/checkpoint.py``, whose Orbax directories the port does not read:
a JAX checkpoint comes in as an ``.npz`` of flax leaves).

A checkpoint is ``<ckpt_dir>/<name>.pt``: a ``torch.save`` of a flat
``{name: tensor}`` mapping (a ``state_dict`` or a slice of one), moved to the
CPU, plus an optional JSON sidecar ``<name>.pt.meta.json`` that
:func:`restore_checkpoint` merges back in. Retention (``keep_last_n``), the
metric-encoded best names (``finetune_epoch_{e}_top1_{acc:.4f}``) and the
latest-epoch lookup parse the epoch out of the name, as the JAX package does.
"""
from __future__ import annotations

import json
import os
import re
from typing import Mapping

import numpy as np
import torch

from .convert import (classifier_state_dict_from_flax, encoder_state_dict_from_flax,
                      unflatten_variables)
from .io import ensure_dir


def save_checkpoint(ckpt_dir: str, name: str, tree: Mapping[str, torch.Tensor],
                    meta: dict | None = None) -> str:
    """Save ``tree`` under ``ckpt_dir/name.pt`` (overwrites). Returns the path."""
    ensure_dir(ckpt_dir)
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}.pt"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in tree.items()}, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    return path


def checkpoint_path(path: str) -> str | None:
    """What ``path`` names: itself, or ``path.pt`` (JAX callers pass
    ``save_dir/best``); None if neither exists."""
    for p in (path, path + ".pt"):
        if os.path.exists(p):
            return p
    return None


def restore_checkpoint(path: str) -> dict:
    """A ``.pt`` checkpoint as its ``{name: tensor}`` mapping, or an ``.npz``
    as the nested flax tree of numpy arrays its leaf paths spell
    (``params/backbone/stem/Conv_0/kernel``). The ``.meta.json`` sidecar, if
    any, is merged in under its own keys."""
    found = checkpoint_path(path)
    if found is None:
        raise FileNotFoundError(f"[ERROR] no checkpoint at {path} (nor {path}.pt)")
    if os.path.isfile(found) and found.endswith(".npz"):
        with np.load(found) as z:
            out = unflatten_variables({k: z[k] for k in z.files})
    elif os.path.isfile(found) and found.endswith(".pt"):
        out = torch.load(found, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"[ERROR] cannot read checkpoint {found}: the port reads a .pt "
                         "state_dict or an .npz of flax leaves (orbax checkpoint "
                         "directories are not read)")
    if os.path.exists(found + ".meta.json"):
        with open(found + ".meta.json") as f:
            out = {**out, **json.load(f)}
    return out


def read_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` in a checkpoint: a ``.pt`` as saved, or an
    ``.npz`` of flax leaves converted (a ``VideoClassifier``'s variables, or
    an encoder-only pretraining blob ``{"params": {"encoder": ...}}``, which
    becomes ``encoder.*`` tensors as the port's pretraining saves them)."""
    blob = restore_checkpoint(path)
    if isinstance(blob.get("params"), Mapping):
        if "head" in blob["params"]:
            return classifier_state_dict_from_flax(blob)
        return encoder_state_dict_from_flax(blob)
    return {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}


_EPOCH_RE = re.compile(r"epoch_(\d+)")


def _by_epoch(ckpt_dir: str, prefix: str) -> list[tuple[int, str]]:
    """(epoch, file name) of each checkpoint named ``prefix...epoch_N...``,
    sidecars and unfinished writes left out, in epoch order."""
    if not os.path.isdir(ckpt_dir):
        return []
    entries = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith(prefix) or name.endswith((".meta.json", ".tmp")):
            continue
        m = _EPOCH_RE.search(name)
        if m:
            entries.append((int(m.group(1)), name))
    return sorted(entries)


def keep_last_n_checkpoints(ckpt_dir: str, keep: int, prefix: str = "ckpt_epoch_") -> list[str]:
    """Delete all but the newest ``keep`` checkpoints matching ``prefix`` (by
    the epoch number in the name), with their sidecars. Returns the deleted
    paths."""
    entries = _by_epoch(ckpt_dir, prefix)
    deleted = []
    for _, name in entries[:-keep] if keep > 0 else entries:
        path = os.path.join(ckpt_dir, name)
        os.remove(path)
        if os.path.exists(path + ".meta.json"):
            os.remove(path + ".meta.json")
        deleted.append(path)
    return deleted


def best_ckpt_name(task: str, epoch: int, metric_name: str, metric_value: float) -> str:
    """Metric-encoded checkpoint name, e.g. finetune_epoch_28_top1_0.6715."""
    return f"{task}_epoch_{epoch}_{metric_name}_{metric_value:.4f}"


def find_latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_epoch_") -> str | None:
    """Newest checkpoint path by epoch number, or None."""
    entries = _by_epoch(ckpt_dir, prefix)
    return os.path.join(ckpt_dir, entries[-1][1]) if entries else None
