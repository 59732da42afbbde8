#!/bin/bash
# SSL pipeline A: EMA teacher-student + VICReg + TOP pretraining
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
echo "[INFO] Running SSL pretraining (pipeline A)"
python -m ssl_vit_video_analytics_tpu_torch.entry.train_ssl --config configs/ssl_train.yaml "$@"
echo "[INFO] SSL pretraining finished"
