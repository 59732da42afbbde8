"""One-time JPEG -> packed uint8 array conversion (the ingest fast path; the
port's copy of the repo's preprocess/pack_frames.py).

Decodes every frame folder under --frame_root once and writes
``packed_{size}.npy`` (uint8 [N, S, S, 3], RGB) alongside the JPEGs. The
training data path then does zero JPEG decode at train time — random frame
access is a memmap gather (see data/frames.py PackedFolderStore). This is
the analogue of the reference's one-time 112x112 frame extraction
(ref: preprocess/extract_frames.py:32) taken one step further.

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.pack_frames \
      --frame_root data/UCF101_frames --size 112
"""
from __future__ import annotations

import argparse
import os

from ..data.frames import pack_frame_dir


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frame_root", required=True)
    p.add_argument("--size", type=int, default=112)
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args()

    n_done = n_skip = 0
    for dirpath, dirnames, files in os.walk(args.frame_root):
        if any(f.endswith(".jpg") for f in files):
            out = pack_frame_dir(dirpath, args.size, overwrite=args.overwrite)
            if out:
                n_done += 1
            else:
                n_skip += 1
            if (n_done + n_skip) % 200 == 0:
                print(f"[INFO] packed {n_done} (skipped {n_skip})", flush=True)
    print(f"[INFO] done: packed {n_done}, skipped {n_skip}")


if __name__ == "__main__":
    main()
