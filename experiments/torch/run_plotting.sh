#!/bin/bash
# CSV-driven paper figures
# PyTorch port (host only: numpy and matplotlib)
set -e
python -m ssl_vit_video_analytics_tpu_torch.entry.plotting --config configs/plotting.yaml "$@"
