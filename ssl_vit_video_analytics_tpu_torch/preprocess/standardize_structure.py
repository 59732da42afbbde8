"""Dataset normalizer (the port's copy of the repo's
preprocess/standardize_structure.py; reference: preprocess/standardize_structure.py).

- normalizes class directory names (spaces/dashes -> underscores, :11-15)
- optional parallel ffmpeg avi->mp4 transcode (libx264 crf 23), deleting the
  source on success (:35-48) — gated on ffmpeg availability
- writes a class-index file (:111-122)

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.standardize_structure \
      --root data/UCF101 [--transcode]
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor


def normalize_name(name: str) -> str:
    out = re.sub(r"[\s\-]+", "_", name.strip())
    return re.sub(r"_+", "_", out)


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def transcode_one(path: str) -> bool:
    out = os.path.splitext(path)[0] + ".mp4"
    cmd = ["ffmpeg", "-y", "-v", "error", "-i", path,
           "-c:v", "libx264", "-crf", "23", "-an", out]
    if subprocess.call(cmd) == 0 and os.path.exists(out) and os.path.getsize(out) > 0:
        os.remove(path)
        return True
    if os.path.exists(out):
        os.remove(out)
    return False


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--transcode", action="store_true", help="avi -> mp4 via ffmpeg")
    p.add_argument("--workers", type=int, default=max(1, (os.cpu_count() or 1)))
    args = p.parse_args()

    # 1. class-dir name normalization
    renamed = 0
    for name in sorted(os.listdir(args.root)):
        src = os.path.join(args.root, name)
        if not os.path.isdir(src):
            continue
        norm = normalize_name(name)
        if norm != name:
            os.rename(src, os.path.join(args.root, norm))
            renamed += 1
    print(f"[INFO] normalized {renamed} class dirs")

    # 2. optional transcode
    if args.transcode:
        if not has_ffmpeg():
            print("[WARN] ffmpeg not found; skipping transcode")
        else:
            avis = []
            for dirpath, _, files in os.walk(args.root):
                avis += [os.path.join(dirpath, f) for f in files if f.lower().endswith(".avi")]
            print(f"[INFO] transcoding {len(avis)} avi files")
            with ThreadPoolExecutor(max_workers=args.workers) as ex:
                oks = list(ex.map(transcode_one, avis))
            print(f"[INFO] transcoded {sum(oks)}/{len(avis)}")

    # 3. class index file
    classes = sorted(d for d in os.listdir(args.root)
                     if os.path.isdir(os.path.join(args.root, d)))
    idx_path = os.path.join(args.root, "class_index.txt")
    with open(idx_path, "w") as f:
        for i, c in enumerate(classes):
            f.write(f"{i} {c}\n")
    print(f"[INFO] wrote {idx_path} ({len(classes)} classes)")


if __name__ == "__main__":
    main()
