#!/bin/bash
# SSL pipeline B: pixel-space VideoMAE pretraining
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
echo "[INFO] Running VideoMAE pretraining (pipeline B)"
python -m ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae --config configs/ssl_mae.yaml "$@"
echo "[INFO] VideoMAE pretraining finished"
