"""Checkpoint saving as torch files (the save half of the JAX package's
``utils/checkpoint.py``, whose Orbax directories the port does not read yet,
ROADMAP queue 1, item 8).

A checkpoint is ``<ckpt_dir>/<name>.pt``: a ``torch.save`` of a flat
``{name: tensor}`` mapping (a ``state_dict`` or a slice of one), moved to the
CPU, plus an optional JSON sidecar ``<name>.pt.meta.json``.
"""
from __future__ import annotations

import json
import os
from typing import Mapping

import torch

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
