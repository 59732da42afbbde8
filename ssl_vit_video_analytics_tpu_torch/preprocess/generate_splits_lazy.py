"""Per-class 70/15/15 train/val/test split files of ``<frame_dir> <label>``
lines (the port's copy of the repo's preprocess/generate_splits_lazy.py;
reference: preprocess/generate_splits_lazy.py:43-72).

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.generate_splits_lazy \
      --frame_root data/UCF101_frames \
      --out_dir data/splits --prefix UCF101 [--ratios 0.7 0.15 0.15] [--seed 42]
"""
from __future__ import annotations

import argparse
import os

from ..data.splits import train_val_test_split, write_split


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frame_root", required=True,
                   help="root of <class>/<video>/ frame folders")
    p.add_argument("--out_dir", default="data/splits")
    p.add_argument("--prefix", default="UCF101")
    p.add_argument("--ratios", nargs=3, type=float, default=(0.7, 0.15, 0.15))
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args()

    classes = sorted(d for d in os.listdir(args.frame_root)
                     if os.path.isdir(os.path.join(args.frame_root, d)))
    by_class = {}
    for label, cls in enumerate(classes):
        cls_dir = os.path.join(args.frame_root, cls)
        vids = sorted(os.path.join(cls_dir, v) for v in os.listdir(cls_dir)
                      if os.path.isdir(os.path.join(cls_dir, v)))
        by_class[label] = vids
    print(f"[INFO] {len(classes)} classes, "
          f"{sum(len(v) for v in by_class.values())} videos")

    splits = train_val_test_split(by_class, tuple(args.ratios), args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, items in splits.items():
        out = os.path.join(args.out_dir, f"{args.prefix}_{name}.txt")
        write_split(items, out)
        print(f"[INFO] {out}: {len(items)} samples")
    with open(os.path.join(args.out_dir, f"{args.prefix}_classes.txt"), "w") as f:
        for label, cls in enumerate(classes):
            f.write(f"{label} {cls}\n")


if __name__ == "__main__":
    main()
