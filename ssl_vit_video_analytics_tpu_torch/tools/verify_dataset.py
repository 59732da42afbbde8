"""Split verifier/cleaner (the port's copy of the repo's verify_dataset.py;
reference: verify_dataset.py).

Checks every split entry has >= --min_frames frames (JPEGs or a packed
array), with --dry_run / --clean modes and a before/after consistency report
(ref: verify_dataset.py:28-35, 38-112, 144-185).

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.tools.verify_dataset \
      --splits data/splits/UCF101_train.txt [...] \
      --min_frames 16 [--clean | --dry_run]
"""
from __future__ import annotations

import argparse
import os
import sys

from ..data.frames import PackedFolderStore
from ..data.splits import read_split, write_split


def check_split(split_file: str, min_frames: int, image_size: int):
    store = PackedFolderStore(image_size)
    good, bad = [], []
    for path, label in read_split(split_file):
        n = store.num_frames(path)
        (good if n >= min_frames else bad).append(((path, label), n))
    return good, bad


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--splits", nargs="+", required=True)
    p.add_argument("--min_frames", type=int, default=16)
    p.add_argument("--image_size", type=int, default=112)
    p.add_argument("--clean", action="store_true",
                   help="rewrite split files without bad entries")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args()

    total_bad = 0
    for split in args.splits:
        good, bad = check_split(split, args.min_frames, args.image_size)
        total_bad += len(bad)
        print(f"[INFO] {split}: {len(good)} ok, {len(bad)} below {args.min_frames} frames")
        for (item, n) in bad[:10]:
            print(f"  [BAD] {item[0]} ({n} frames)")
        if len(bad) > 10:
            print(f"  ... and {len(bad) - 10} more")
        if args.clean and not args.dry_run and bad:
            backup = split + ".bak"
            os.replace(split, backup)
            write_split([item for item, _ in good], split)
            # consistency re-check
            good2, bad2 = check_split(split, args.min_frames, args.image_size)
            print(f"[INFO] cleaned {split} (backup {backup}): "
                  f"now {len(good2)} ok, {len(bad2)} bad")
    if total_bad == 0:
        print("[INFO] all splits verified clean")
    sys.exit(0 if (total_bad == 0 or args.clean) else 1)


if __name__ == "__main__":
    main()
