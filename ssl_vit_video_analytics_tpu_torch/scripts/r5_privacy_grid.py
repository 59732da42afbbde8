"""Feature-privacy grid with attacker repeats (counterpart of the JAX
package's ``scripts/r5_privacy_grid.py``).

Runs the sigma x mask grid with attacker_repeats=3 (each repeat resamples
the perturbation AND the attacker init/order) so the reference-range segment
of fig18/fig20 carries a noise floor: a single repeat cannot tell a real
sigma effect from attacker noise. Utility model: a finetuned classifier
checkpoint (``best`` names the port's ``best.pt``); split: a validation
split of the hard fixture. Reference protocol per src/run_privacy.py:309-326.
Runs the port's ``entry.run_privacy`` on ``--device`` (default cuda).

Run (card): python -m ssl_vit_video_analytics_tpu_torch.scripts.r5_privacy_grid \\
    [--ckpt path] [--split path] [--out results/privacy_r5] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

from ssl_vit_video_analytics_tpu_torch.entry import run_privacy
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import checkpoint_path


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt",
                   default="results/separations_xl_r4/m_ft_ssl/finetune/ft_ssl/best")
    p.add_argument("--split", default="/tmp/ssl_campaign/data_app10_xl/splits/val.txt")
    p.add_argument("--out", default="results/privacy_r5")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--classes", type=int, default=24)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda); --device cpu runs on the CPU")
    args = p.parse_args(argv)

    # resolved as restore_checkpoint resolves it: the path or path.pt, a file
    found = checkpoint_path(args.ckpt)
    if found is None or os.path.isdir(found):
        raise FileNotFoundError(f"utility ckpt missing: {args.ckpt}")
    cfg = {
        "seed": 42,
        "device": {"compute_dtype": "bfloat16"},
        "dataset": {"backend": "packed", "split": args.split,
                    "num_classes": args.classes, "clip_len": 16, "stride": 1,
                    "image_size": 112, "device_resident": "true"},
        "paths": {"split_root": ""},
        "model": {"embed_dim": 256, "finetune_ckpt": args.ckpt},
        "runtime": {"batch_size": 16},
        "visual_privacy": {"enabled": False},
        "feature_privacy": {"enabled": True,
                            "noise_sigmas": [0.0, 0.05, 0.1, 0.2,
                                             0.5, 1.0, 2.0, 4.0],
                            "mask_ratios": [0.0, 0.2, 0.4],
                            "attacker_epochs": 10, "attacker_lr": 1e-3,
                            "attacker_repeats": args.repeats},
        "output": {"save_dir": args.out},
    }
    run_privacy.run(cfg, log=print, device=args.device)


if __name__ == "__main__":
    main()
