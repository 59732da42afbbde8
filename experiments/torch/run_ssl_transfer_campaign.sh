#!/bin/bash
# SSL-transfer evidence campaign: pipeline-A pretrain -> ft_ssl vs ft_random
# vs linear_probe at equal budget -> feature-privacy grid, then figures.
# All campaign knobs pass through (e.g. --ft_augment --ft_lr 2e-4 --smoke).
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
echo "[INFO] Running SSL-transfer campaign"
python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign "$@"
python -m ssl_vit_video_analytics_tpu_torch.scripts.make_campaign_artifacts
echo "[INFO] Campaign + artifacts finished"
