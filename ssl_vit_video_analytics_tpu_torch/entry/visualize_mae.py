"""Pipeline-B reconstruction viewer (counterpart of the JAX package's
``entry/visualize_mae.py``; reference: src/visualize_mae.py).

Builds the pipeline-B model of the config (``train_ssl_mae.build_model``,
seeded init) on ``--device`` (default cuda), loads a checkpoint into it (a
port ``.pt``, or a JAX ``.npz`` of flax leaves; an encoder-only one, which
``train_ssl_mae`` writes by default, is grafted onto the random decoder
with a warning, ref: src/visualize_mae.py:104-108), picks a few clips of
the training split, and saves orig|masked|recon triptychs. The forward runs
through ``ops/attention.py``: K1 on a card. Each clip's tube mask is drawn
from a ``torch.Generator`` seeded with the clip's index (JAX: from
``jax.random.key(i)``; the same law, other numbers).

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.entry.visualize_mae \\
      --config configs/ssl_mae.yaml --ckpt results/tinymae_v1/ckpt_epoch_200 \\
      --num_samples 2
"""
from __future__ import annotations

import os
from typing import Mapping

import torch

from ..data.masking import get_tube_mask
from ..models.mae import TinyVideoMAE
from ..reporting.visualize import save_reconstruction_triptych
from ..train.finetune_engine import init_model
from ..utils.checkpoint import checkpoint_path, restore_checkpoint
from ..utils.convert import encoder_state_dict_from_flax, mae_state_dict_from_flax
from ..utils.io import ensure_dir
from . import common
from .train_ssl_mae import build_model

NO_DECODER = ("[WARN] checkpoint has no decoder weights; reconstructions "
              "use a randomly initialized decoder")


def checkpoint_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The pipeline-B tensors in a checkpoint: a port ``.pt`` as saved
    (encoder-only ``encoder.*`` or the whole model), or a JAX ``.npz``'s flax
    tree converted (``params/decoder`` present or not)."""
    blob = restore_checkpoint(path)
    if isinstance(blob.get("params"), Mapping):
        if "decoder" in blob["params"]:
            return mae_state_dict_from_flax(blob)
        return encoder_state_dict_from_flax(blob)
    return {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}


def load_model(cfg: dict, ckpt: str | None, device: torch.device, dtype: torch.dtype,
               log=print) -> TinyVideoMAE:
    """The config's pipeline-B model in eval mode on ``device``: seeded
    init, then ``ckpt`` if it exists (an encoder-only one grafted)."""
    model = build_model(cfg, dtype)
    init_model(model, torch.Generator().manual_seed(0))
    found = checkpoint_path(ckpt) if ckpt else None
    if found:
        sd = checkpoint_state_dict(found)
        if all(k.startswith("encoder.") for k in sd):
            # encoder-only checkpoint: graft encoder, keep random decoder
            log(NO_DECODER)
            model.encoder.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
        else:
            model.load_state_dict(sd)
        log(f"[INFO] loaded {ckpt}")
    else:
        log(f"[WARN] no checkpoint ({ckpt}); random weights")
    return model.to(device).eval()


def run(cfg: dict, ckpt: str | None = None, num_samples: int = 2,
        out_dir: str = "results/mae_vis", device: str | torch.device | None = None,
        log=print) -> list[str | None]:
    """Triptychs ``recon_{i:03d}.png`` of the first ``num_samples`` clips of
    the training split; returns their paths (None without matplotlib)."""
    device = common.device_from(cfg, device)
    dtype = common.compute_dtype_from(cfg, device)
    ds = common.dataset_from_cfg(cfg, common.split_path(cfg, cfg["dataset"]["train_split"]),
                                 "ssl")
    T, S = ds.clip_len, ds.image_size
    L = (S // 8) ** 2
    model = load_model(cfg, ckpt, device, dtype, log)

    ensure_dir(out_dir)
    ssl = cfg.get("ssl", {})
    ratio = float(ssl.get("mask_ratio", 0.9))
    outs = []
    for i in range(min(num_samples, len(ds))):
        mask = get_tube_mask(torch.Generator(device=device).manual_seed(i), 1, T, L, ratio,
                             device)
        out = save_reconstruction_triptych(
            model, ds.get_clip(i), mask, 8, os.path.join(out_dir, f"recon_{i:03d}.png"), dtype,
            norm_pix=bool(ssl.get("norm_pix_loss", False)))
        log(f"[INFO] wrote {out}")
        outs.append(out)
    return outs


def main():
    p = common.make_parser("VideoMAE reconstruction viewer")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--num_samples", type=int, default=2)
    p.add_argument("--out_dir", type=str, default="results/mae_vis")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    cfg = common.load_merged_config(args, "configs/ssl_mae.yaml")
    run(cfg, args.ckpt, args.num_samples, args.out_dir, args.device)


if __name__ == "__main__":
    main()
