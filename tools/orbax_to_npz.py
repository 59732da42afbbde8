"""Convert a JAX Orbax checkpoint into the ``.npz`` of flax leaves that the
PyTorch port reads.

The port imports no JAX, so it cannot open an Orbax directory. This tool
runs where JAX runs: it restores the checkpoint with the JAX package's
``utils.checkpoint.restore_checkpoint`` and writes ``<out>.npz``, one array
per leaf of ``params`` and ``batch_stats`` keyed by its ``/``-joined path
(``params/backbone/stem/Conv_0/kernel``). The port's
``utils.checkpoint.restore_checkpoint`` unflattens it
(``utils.convert.unflatten_variables``) and ``read_checkpoint`` converts it
into a port ``state_dict``: a ``VideoClassifier``'s variables, or an
encoder-only pretraining blob ``{"params": {"encoder": ...}}``. The
checkpoint's metadata (its ``.meta.json`` sidecar, and top-level scalars of
the tree such as ``step``) goes to ``<out>.npz.meta.json``, which the port
merges back in. The optimizer state is not written: the port's optimizer
keeps its own layout.

Usage:
  python tools/orbax_to_npz.py --ckpt results/finetune/two_stage/best \\
      --out results/finetune/two_stage/best_flax
  # then: --set model.finetune_ckpt=results/finetune/two_stage/best_flax.npz
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree, prefix: str) -> dict[str, np.ndarray]:
    """The port's ``utils.convert.flatten_variables``, kept here so that
    this tool needs no torch where JAX runs."""
    flat = {}
    for name, sub in tree.items():
        key = f"{prefix}/{name}"
        if isinstance(sub, dict):
            flat.update(_flatten(sub, key))
        elif sub is not None:
            flat[key] = np.asarray(sub)
    return flat


def orbax_to_npz(ckpt: str, out: str) -> str:
    """Write the flax leaves of the Orbax checkpoint ``ckpt`` to
    ``out`` (``.npz`` added if missing) and its metadata beside it.
    Returns the ``.npz`` path."""
    from ssl_vit_video_analytics_tpu.utils.checkpoint import restore_checkpoint

    blob = restore_checkpoint(ckpt)
    flat = {}
    for collection in COLLECTIONS:
        if isinstance(blob.get(collection), dict):
            flat.update(_flatten(blob[collection], collection))
    if not flat:
        raise SystemExit(f"[ERROR] {ckpt} holds no params or batch_stats")
    meta = {}
    sidecar = os.path.abspath(ckpt) + ".meta.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    for key, value in blob.items():
        if (key not in meta and value is not None
                and not isinstance(value, (dict, list, tuple)) and np.ndim(value) == 0):
            meta[key] = np.asarray(value).item()
    path = out if out.endswith(".npz") else out + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    if meta:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    return path


def main():
    p = argparse.ArgumentParser(description="JAX Orbax checkpoint -> .npz of flax leaves "
                                            "for the PyTorch port")
    p.add_argument("--ckpt", required=True, help="Orbax checkpoint directory")
    p.add_argument("--out", required=True, help="output path (.npz added if missing)")
    args = p.parse_args()
    path = orbax_to_npz(args.ckpt, args.out)
    with np.load(path) as z:
        n = len(z.files)
    print(f"[INFO] wrote {path} ({n} leaves)")


if __name__ == "__main__":
    main()
