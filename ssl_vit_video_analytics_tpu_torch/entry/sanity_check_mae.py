"""Pipeline-C smoke test (counterpart of the JAX package's
``entry/sanity_check_mae.py``; reference: src/scripts/sanity_check_mae.py).

Loads one real clip from the config's split, builds the TinyViTMAE of
``entry/train_mae.build_model``, draws a token mask, runs the forward, the
reconstruction statistics and one backward of the l2 loss (eval mode, as
the JAX check applies the model), and prints ``[SANITY] PASSED``. Runs on
the card unless ``--device cpu`` is given.

    python -m ssl_vit_video_analytics_tpu_torch.entry.sanity_check_mae \\
        --config configs/mae_train.yaml
"""
from __future__ import annotations

import math

import torch

from ..data.masking import make_token_mask
from ..ops.preprocess import normalize_clip
from ..train.finetune_engine import init_model
from ..train.losses import build_mae_loss, reconstruction_error_stats
from ..train.state import global_norm
from . import common
from .train_mae import build_model


def run(cfg: dict, device: str | torch.device | None = None, log=print) -> dict:
    """Forward, statistics and one backward on the split's first clip.
    Returns the statistics and the gradient norm; raises on a non-finite
    gradient."""
    device = common.device_from(cfg, device)
    dtype = common.compute_dtype_from(cfg, device)
    ds = common.dataset_from_cfg(cfg, common.split_path(cfg, cfg["dataset"]["train_split"]),
                                 "ssl")
    clip_u8 = torch.from_numpy(ds.get_clip(0)[None]).to(device)
    T = clip_u8.shape[1]
    mae = cfg["mae"]
    P = int(mae.get("stage4_pool", 3)) ** 2

    model = build_model(cfg, dtype)
    init_model(model, torch.Generator().manual_seed(1))
    model.to(device).eval()
    clip = normalize_clip(clip_u8, dtype=dtype)
    mask = make_token_mask(torch.Generator(device=device).manual_seed(0), 1, T, P,
                           float(mae.get("mask_ratio", 0.8)), str(mae.get("mask_mode", "tube")))
    log(f"[SANITY] clip {tuple(clip.shape)}, mask {tuple(mask.shape)} "
        f"({int(mask.sum())} masked of {mask.numel()})")

    with torch.no_grad():
        rec, target = model(clip, mask)
    stats = {k: float(v) for k, v in reconstruction_error_stats(rec, target, mask).items()}
    log(f"[SANITY] forward ok: rec {tuple(rec.shape)}, stats {stats}")

    rec, target = model(clip, mask)
    params = list(model.parameters())
    grads = torch.autograd.grad(build_mae_loss("l2")(rec, target, mask), params)
    gnorm = float(global_norm(grads))
    if not math.isfinite(gnorm):
        raise AssertionError("non-finite gradients")
    log(f"[SANITY] backward ok: grad_norm={gnorm:.4f}")
    log("[SANITY] PASSED")
    return {"stats": stats, "grad_norm": gnorm}


def main():
    p = common.make_parser("MAE pipeline-C sanity check")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: device.name of the config, else cuda)")
    args = p.parse_args()
    run(common.load_merged_config(args, "configs/mae_train.yaml"), device=args.device)


if __name__ == "__main__":
    main()
