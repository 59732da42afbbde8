"""Dataset acquisition (counterpart of the reference's download_dataset.ipynb;
the port's copy of the repo's preprocess/download_dataset.py).

The reference ships a notebook that gdown-fetches pre-extracted frame
archives from Google Drive and unzips them under ./data
(ref: download_dataset.ipynb cells 1-3; the Drive file ids below are the
ones its comment block lists). This CLI does the same thing headlessly, and
is NO-NETWORK-TOLERANT: every stage that can be satisfied locally is — an
already-downloaded zip is verified and extracted, an already-extracted tree
is accepted as-is, and with --synthetic-fallback a fully offline environment
still produces a runnable (synthetic) dataset so the downstream pipeline
(experiments/torch/run_full_pipeline_dataset.sh) can be smoke-tested end to end.

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.download_dataset --dataset UCF101_frames --root data
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.download_dataset --dataset all --list
  python -m ssl_vit_video_analytics_tpu_torch.preprocess.download_dataset --dataset UCF101_frames \
      --synthetic-fallback   # offline: tiny synthetic standin + splits

Integrity: Google Drive serves these archives without published checksums,
so verification is (a) zipfile CRC test of every member before extraction,
and (b) post-extraction frame-tree validation via verify_dataset.py's
checks (run tools/verify_dataset.py separately for the full report).
"""
from __future__ import annotations

import argparse
import os
import sys
import zipfile

# name -> (drive file id, expected top-level layout note)
# ids from the reference notebook's manifest comment
# (ref: download_dataset.ipynb cell 2).
ARTIFACTS = {
    "splits": ("1SUPLYwkx5WFhiJM6QeI7HDnAPoZqsPQx",
               "train/val/test .txt split lists"),
    "UCF101_frames": ("1tnhpsB1mExoWlhP9UhyMbc2fM4ovE6mR",
                      "class/video/frame_XXXX.jpg tree, 101 classes"),
    "FaceForensics_frames": ("19BHJ0EGL5A4aKmdRynLJ2cSmswQ_NQ1C",
                             "face frames for the visual-privacy eval"),
    "hmdb51_frames": ("1xSlq86xKTJBDb0VPolE1u5A9R5jV-Vxa",
                      "HMDB51 frame tree"),
    "Kinetics-400-Tiny_frames": ("1I3A8jYG-6O-QSK19RV2B8Srqv0hhDLkz",
                                 "Kinetics-400 tiny subset frame tree"),
    "UCF101_32_frames": ("1Uirk4skIdNbZ7P1h0xuDooVeLEWUrz8q",
                         "32-frame UCF101 variant"),
}


def log(msg: str) -> None:
    print(f"[download_dataset] {msg}", flush=True)


def verify_zip(path: str) -> bool:
    """CRC-check every member (no published checksums for these archives)."""
    try:
        with zipfile.ZipFile(path) as zf:
            bad = zf.testzip()
        if bad is not None:
            log(f"CRC FAILED at member {bad} in {path}")
            return False
        return True
    except zipfile.BadZipFile:
        log(f"not a valid zip: {path}")
        return False


def extract(path: str, dest: str) -> None:
    os.makedirs(dest, exist_ok=True)
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
        total = sum(i.file_size for i in infos) or 1
        done = 0
        for i, info in enumerate(infos):
            zf.extract(info, dest)
            done += info.file_size
            if i % 2000 == 0:
                log(f"  extract {done / total:5.1%} ({done / 1e6:.0f} MB)")
    log(f"extracted {len(infos)} files -> {dest}")


def try_download(file_id: str, out_path: str) -> bool:
    """gdown fetch; returns False (with instructions) when offline or gdown
    is unavailable — never raises."""
    try:
        import gdown  # not baked into this image; present in ref env
    except ImportError:
        log("gdown not installed (pip install gdown) — skipping network fetch")
        return False
    try:
        url = f"https://drive.google.com/uc?id={file_id}"
        log(f"fetching {url} -> {out_path}")
        got = gdown.download(url, out_path, quiet=False)
        return got is not None and os.path.exists(out_path)
    except Exception as e:  # noqa: BLE001 — any network failure = offline
        log(f"download failed ({type(e).__name__}: {e}) — offline?")
        return False


def synthetic_fallback(root: str, name: str) -> None:
    """Offline standin: a small hard synthetic frame tree + splits with the
    same on-disk layout the real archives extract to, so every downstream
    stage (packing, training entries, verify_dataset) runs unchanged."""
    from ..data.fixtures import make_hard_synthetic_dataset

    dest = os.path.join(root, name)
    splits = make_hard_synthetic_dataset(
        dest, num_classes=4, videos_per_class=6, num_frames=16,
        image_size=112, seed=0)
    log(f"synthetic standin ready under {dest}: {splits}")


def fetch_one(name: str, root: str, args) -> bool:
    file_id, layout = ARTIFACTS[name]
    dest = os.path.join(root, name)
    if os.path.isdir(dest) and os.listdir(dest):
        log(f"{name}: already extracted at {dest} — nothing to do")
        return True
    zip_path = os.path.join(root, f"{name}.zip")
    if not os.path.exists(zip_path):
        if not try_download(file_id, zip_path):
            log(f"{name}: NOT AVAILABLE offline. Manual path: download "
                f"https://drive.google.com/uc?id={file_id} to {zip_path} "
                f"and re-run; expected layout: {layout}")
            if args.synthetic_fallback:
                synthetic_fallback(root, name)
                return True
            return False
    if not verify_zip(zip_path):
        log(f"{name}: corrupt archive {zip_path}; delete and re-download")
        return False
    extract(zip_path, dest)
    if not args.keep_zip:
        os.remove(zip_path)
    return True


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="UCF101_frames",
                   help=f"one of {sorted(ARTIFACTS)} or 'all'")
    p.add_argument("--root", default="data")
    p.add_argument("--list", action="store_true", help="print the manifest")
    p.add_argument("--keep-zip", action="store_true")
    p.add_argument("--synthetic-fallback", action="store_true",
                   help="offline: generate a synthetic standin dataset")
    args = p.parse_args()

    if args.list:
        for k, (fid, layout) in ARTIFACTS.items():
            print(f"{k:28s} drive_id={fid}  ({layout})")
        return 0

    names = sorted(ARTIFACTS) if args.dataset == "all" else [args.dataset]
    for n in names:
        if n not in ARTIFACTS:
            log(f"unknown dataset {n}; --list shows the manifest")
            return 2
    os.makedirs(args.root, exist_ok=True)
    ok = all(fetch_one(n, args.root, args) for n in names)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
