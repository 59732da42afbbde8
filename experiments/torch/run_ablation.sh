#!/bin/bash
# Ablation and sensitivity studies (override-based, no config rewriting)
# PyTorch port: each cell a subprocess of the port's entries; --device is passed on
set -e
echo "[INFO] Running ablation and sensitivity studies"
python -m ssl_vit_video_analytics_tpu_torch.entry.ablations "$@"
echo "[INFO] Ablation experiments finished"
