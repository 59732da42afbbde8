#!/bin/bash
# SSL pipeline C: feature-space token MAE pretraining
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
echo "[INFO] Running token-MAE pretraining (pipeline C)"
python -m ssl_vit_video_analytics_tpu_torch.entry.train_mae --config configs/mae_train.yaml "$@"
echo "[INFO] Token-MAE pretraining finished"
