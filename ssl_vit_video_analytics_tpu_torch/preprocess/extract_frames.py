"""Video -> JPEG frame-folder extraction (the port's copy of the repo's
preprocess/extract_frames.py; reference: preprocess/extract_frames.py).

Reads each video, resizes to --size, writes frame_%05d.jpg into a per-video
directory, skips already-complete videos, and deletes partially-extracted
directories on failure so corrupt videos never enter splits (ref: :43-48).

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.extract_frames --video_root data/UCF101 \
      --out_root data/UCF101_frames --size 112 [--workers N] [--pack]
"""
from __future__ import annotations

import argparse
import os
import shutil
from concurrent.futures import ProcessPoolExecutor

import cv2

VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".webm")


def extract_one_video(args_tuple) -> tuple[str, bool]:
    video_path, out_dir, size, pack = args_tuple
    if os.path.isdir(out_dir) and any(n.endswith(".jpg") for n in os.listdir(out_dir)):
        return out_dir, True  # skip existing
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    ok_any = False
    idx = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.resize(frame, (size, size), interpolation=cv2.INTER_LINEAR)
            cv2.imwrite(os.path.join(out_dir, f"frame_{idx:05d}.jpg"), frame)
            ok_any = True
            idx += 1
    finally:
        cap.release()
    if not ok_any:
        # failed-dir cleanup, like the reference
        shutil.rmtree(out_dir, ignore_errors=True)
        return out_dir, False
    if pack:
        from ..data.frames import pack_frame_dir
        pack_frame_dir(out_dir, size)
    return out_dir, True


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--video_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--size", type=int, default=112)
    p.add_argument("--workers", type=int, default=max(1, (os.cpu_count() or 1)))
    p.add_argument("--pack", action="store_true",
                   help="also write packed_{size}.npy (the packed fast path)")
    args = p.parse_args()

    jobs = []
    for dirpath, _, files in os.walk(args.video_root):
        for f in files:
            if f.lower().endswith(VIDEO_EXTS):
                rel = os.path.relpath(os.path.join(dirpath, f), args.video_root)
                out_dir = os.path.join(args.out_root, os.path.splitext(rel)[0])
                jobs.append((os.path.join(dirpath, f), out_dir, args.size, args.pack))

    print(f"[INFO] {len(jobs)} videos -> {args.out_root}")
    done = failed = 0
    if args.workers > 1:
        with ProcessPoolExecutor(max_workers=args.workers) as ex:
            for _, ok in ex.map(extract_one_video, jobs):
                done += ok
                failed += not ok
    else:
        for job in jobs:
            _, ok = extract_one_video(job)
            done += ok
            failed += not ok
    print(f"[INFO] extracted {done} ok, {failed} failed")


if __name__ == "__main__":
    main()
