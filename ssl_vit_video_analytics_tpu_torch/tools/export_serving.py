"""Serving export: the classifier forward as one ``torch.export`` artifact
(``.pt2``) that serves WITHOUT the model code or checkpoint (counterpart of
the JAX repo's ``tools/export_serving.py``, which writes StableHLO).

The trained ``VideoClassifier`` of the ``run_dynamic`` schema is traced
once in eval mode with its weights baked in, and saved to one file. A
serving host loads it with ``torch.export.load`` and calls it: no port
package, no checkpoint tree, no config drift between training and serving.
The batch dimension is exported SYMBOLICALLY (``torch.export.Dim``), so one
artifact serves any batch size.

Notes:
  - Exported with the plain PyTorch attention, as the JAX tool exports with
    its XLA attention: the K1 kernel is a ``ctypes`` call that cannot be
    traced, and the artifact must not need the port's built kernel library.
    The plain attention computes the same function (``chip_smoke.py`` holds
    K1 to it); the live model keeps K1. The attention is set back in a
    ``finally``.
  - An artifact pins dtype, input rank and every size but the batch (1 to
    65535 frames' worth of clips), and the device it serves on. By default
    that is the device it was exported on, and ``--out`` is its file.
    ``--platforms`` (as the JAX tool's, which writes one artifact for every
    listed platform) names torch device types, ``cpu`` and ``cuda``: the
    classifier is exported once, on ``--device``, and the program is moved
    to each listed platform (``torch.export.passes.move_to_device_pass``),
    one file each, the platform before ``--out``'s suffix
    (``results/classifier.cpu.pt2``, ``results/classifier.cuda.pt2``). An
    artifact exported on a card thus serves on a host without one. Any
    other name raises before anything is exported.
  - ``--load PATH`` serves the artifact at PATH. Where PATH is not a file
    but an ``--out`` of ``--platforms``, it picks the file of this host's
    platform: ``cuda`` where torch sees a card, else ``cpu``.

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.tools.export_serving \\
      --config configs/dynamic.yaml --out results/classifier.pt2   # export (ckpt from cfg)
  python -m ssl_vit_video_analytics_tpu_torch.tools.export_serving \\
      --config configs/dynamic.yaml --platforms cpu cuda           # classifier.{cpu,cuda}.pt2
  python -m ssl_vit_video_analytics_tpu_torch.tools.export_serving \\
      --load results/classifier.pt2 --batch 8                      # smoke/bench a served fn
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import os
import time

import numpy as np
import torch

from ..entry.common import device_from
from ..entry.run_dynamic import load_classifier
from ..models.classifier import VideoClassifier
from ..models.layers import MultiHeadAttention
from ..utils.config import load_config

# an example batch of 1 would make torch.export specialize the dimension
EXAMPLE_BATCH = 2
# the most frames one call takes: traced on a card, the forward guards the
# frames of a batch (b * clip_len) to a CUDA grid dimension, and the
# symbolic batch must declare that bound
MAX_FRAMES = 65535
# the platforms --platforms takes: torch device types
PLATFORMS = ("cpu", "cuda")


@contextlib.contextmanager
def plain_attention(model: torch.nn.Module):
    """Every attention layer of ``model`` on the plain PyTorch path; the
    layers' own settings restored after."""
    layers = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    prev = [m.attn_impl for m in layers]
    for m in layers:
        m.attn_impl = "plain"
    try:
        yield
    finally:
        for m, impl in zip(layers, prev):
            m.attn_impl = impl


def export_model(model: VideoClassifier, clip_len: int, image_size: int,
                 log=print) -> torch.export.ExportedProgram:
    """``model``'s forward on fp32 clips ``[b, clip_len, S, S, 3]`` with a
    symbolic ``b`` (1 to ``MAX_FRAMES // clip_len``), through the plain
    attention."""
    device = next(model.parameters()).device
    example = torch.zeros(EXAMPLE_BATCH, clip_len, image_size, image_size, 3, device=device)
    log("[INFO] exporting with the plain attention (portable: no kernel library needed)")
    with plain_attention(model), torch.no_grad():
        batch = torch.export.Dim("b", min=1, max=MAX_FRAMES // clip_len)
        return torch.export.export(model, (example,), dynamic_shapes={"clip": {0: batch}})


def export_classifier(cfg: dict, device: str | torch.device, dtype: torch.dtype = torch.float32,
                      log=print) -> torch.export.ExportedProgram:
    """Build + restore the classifier from ``cfg`` as entry.run_dynamic
    does (``model.finetune_ckpt``, or seeded random weights with a
    warning), bake its weights in, export with a symbolic batch."""
    model = load_classifier(cfg, dtype, torch.device(device), log)
    return export_model(model, int(cfg["dataset"]["clip_len"]),
                        int(cfg["dataset"]["image_size"]), log)


def artifact_input(program: torch.export.ExportedProgram) -> tuple[tuple, torch.device]:
    """The shape (the batch a symbol) and device of the artifact's input."""
    name = program.graph_signature.user_inputs[0]
    val = next(n for n in program.graph.nodes if n.op == "placeholder"
               and n.name == name).meta["val"]
    return tuple(val.shape), val.device


def check_platforms(platforms: list[str]) -> None:
    """Raise on a name that is not one of :data:`PLATFORMS`."""
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"unknown platform(s) {unknown}: --platforms takes torch device "
                         f"types {list(PLATFORMS)}")


def artifact_path(out: str, platform: str) -> str:
    """The file of ``platform``'s artifact for ``--out out``: the platform
    before the suffix (``classifier.pt2`` -> ``classifier.cpu.pt2``)."""
    root, ext = os.path.splitext(out)
    return f"{root}.{platform}{ext}"


def pick_artifact(path: str) -> str:
    """``path`` where it is a file, else the artifact of this host's platform
    (``cuda`` where torch sees a card, else ``cpu``) written for the ``--out``
    ``path`` by ``--platforms``."""
    if os.path.isfile(path):
        return path
    return artifact_path(path, "cuda" if torch.cuda.is_available() else "cpu")


def to_platforms(program: torch.export.ExportedProgram,
                 platforms: list[str]) -> dict[str, torch.export.ExportedProgram]:
    """``program`` for each of ``platforms``: itself on its own device type,
    else a copy moved there by ``torch.export.passes.move_to_device_pass``
    (in torch since 2.6); a torch without that pass raises."""
    check_platforms(platforms)
    try:
        from torch.export.passes import move_to_device_pass
    except ImportError as e:
        raise RuntimeError(f"torch {torch.__version__} has no torch.export.passes."
                           f"move_to_device_pass: --platforms needs it") from e
    source = artifact_input(program)[1].type
    return {platform: program if platform == source
            else move_to_device_pass(copy.deepcopy(program), platform)
            for platform in platforms}


def export_platforms(cfg: dict, device: str | torch.device, platforms: list[str],
                     dtype: torch.dtype = torch.float32,
                     log=print) -> dict[str, torch.export.ExportedProgram]:
    """The classifier exported once on ``device`` (:func:`export_classifier`)
    and put on each of ``platforms`` by :func:`to_platforms`."""
    check_platforms(platforms)
    return to_platforms(export_classifier(cfg, device, dtype, log), platforms)


def serve(path: str, batch: int, iters: int, log=print) -> dict:
    """Load the artifact at ``path`` and call it on a random fp32 batch:
    logits shape and finiteness, then ms per batch over ``iters`` calls, each
    ended by a host copy of one logit."""
    program = torch.export.load(path)
    fn = program.module()
    (_, T, S, _, _), device = artifact_input(program)
    clip = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, int(T), int(S), int(S), 3)).astype(np.float32)).to(device)
    with torch.no_grad():
        logits = fn(clip)
        finite = bool(torch.isfinite(logits).all())
        log(f"[serve] {path}: in {tuple(clip.shape)} -> logits {tuple(logits.shape)}, "
            f"finite={finite}")
        t0 = time.perf_counter()
        for _ in range(iters):
            float(fn(clip)[0, 0])  # host sync per call
    dt = (time.perf_counter() - t0) / iters * 1e3
    log(f"[serve] {dt:.2f} ms/batch ({dt / batch:.2f} ms/clip, "
        f"batch {batch}, {iters} iters)")
    return {"shape": tuple(logits.shape), "finite": finite, "ms_per_batch": dt}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="task YAML (run_dynamic schema)")
    p.add_argument("--base", default="configs/base.yaml")
    p.add_argument("--set", nargs="*", action="extend", default=[],
                   help="dotted overrides (--set a=1 b=2, or --set repeated)")
    p.add_argument("--out", default="results/classifier.pt2")
    p.add_argument("--device", default=None,
                   help="torch device to export on (default: device.name of the config, "
                        "else cuda)")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="e.g. --platforms cpu cuda: one artifact each, OUT with the platform "
                        "before its suffix (default: the export device's, at OUT)")
    p.add_argument("--load", default=None,
                   help="artifact to deserialize+run (an OUT of --platforms: this host's)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()

    if args.load:
        serve(pick_artifact(args.load), args.batch, args.iters)
        return

    if args.platforms:
        check_platforms(args.platforms)  # before the config is read or anything exported
    cfg = load_config(args.config, base=args.base or None, overrides=args.set)
    device = device_from(cfg, args.device)
    if args.platforms:
        programs = {artifact_path(args.out, platform): program for platform, program
                    in export_platforms(cfg, device, args.platforms).items()}
    else:
        programs = {args.out: export_classifier(cfg, device)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for path, program in programs.items():
        torch.export.save(program, path)
        print(f"[export] wrote {path} ({os.path.getsize(path) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
