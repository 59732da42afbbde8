#!/bin/bash
# End-to-end dataset preparation: acquire -> standardize -> extract -> pack
# -> splits -> verify.
# PyTorch port: imports the port only, so it runs where JAX is not installed
# (the card's machine). Acquisition (counterpart of the reference's
# download_dataset.ipynb) is a separate, no-network-tolerant step — run it
# first if videos/frames are not already on disk:
#   python -m ssl_vit_video_analytics_tpu_torch.preprocess.download_dataset --dataset UCF101_frames --root data
# (offline: add --synthetic-fallback for a runnable synthetic standin)
set -e
VIDEO_ROOT=${1:-data/UCF101}
FRAME_ROOT=${2:-data/UCF101_frames}
PREFIX=${3:-UCF101}
SIZE=${4:-112}
python -m ssl_vit_video_analytics_tpu_torch.preprocess.standardize_structure --root "$VIDEO_ROOT"
python -m ssl_vit_video_analytics_tpu_torch.preprocess.extract_frames --video_root "$VIDEO_ROOT" --out_root "$FRAME_ROOT" --size "$SIZE" --pack
python -m ssl_vit_video_analytics_tpu_torch.preprocess.generate_splits_lazy --frame_root "$FRAME_ROOT" --out_dir data/splits --prefix "$PREFIX"
python -m ssl_vit_video_analytics_tpu_torch.tools.verify_dataset --splits data/splits/${PREFIX}_train.txt data/splits/${PREFIX}_val.txt data/splits/${PREFIX}_test.txt --min_frames 16 --clean
echo "[INFO] Dataset pipeline finished"
