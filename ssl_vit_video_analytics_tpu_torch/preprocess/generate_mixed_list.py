"""Cross-dataset SSL pretraining list with placeholder label 0, shuffled (the
port's copy of the repo's preprocess/generate_mixed_list.py; reference:
preprocess/generate_mixed_list.py:19-45).

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.generate_mixed_list \
      --roots data/UCF101_frames \
      data/HMDB51_frames data/K400Tiny_frames --out data/splits/mixed_ssl.txt
"""
from __future__ import annotations

import argparse
import os
import random

from ..data.splits import write_split


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--roots", nargs="+", required=True)
    p.add_argument("--out", default="data/splits/mixed_ssl.txt")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args()

    items = []
    for root in args.roots:
        for dirpath, dirnames, files in os.walk(root):
            if any(f.endswith((".jpg", ".npy")) for f in files):
                items.append((dirpath, 0))
    rng = random.Random(args.seed)
    rng.shuffle(items)
    write_split(items, args.out)
    print(f"[INFO] {args.out}: {len(items)} samples from {len(args.roots)} roots")


if __name__ == "__main__":
    main()
