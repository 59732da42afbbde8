#!/bin/bash
# Privacy evaluation: visual + feature layers
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
echo "[INFO] Running privacy evaluation"
python -m ssl_vit_video_analytics_tpu_torch.entry.run_privacy --config configs/privacy.yaml "$@"
echo "[INFO] Privacy evaluation finished"
