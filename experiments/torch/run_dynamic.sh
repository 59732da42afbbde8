#!/bin/bash
# Dynamic inference: all three modes, CSVs into separate files
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
for MODE in early_exit frame_gating hybrid; do
  echo "[INFO] dynamic mode=$MODE"
  python -m ssl_vit_video_analytics_tpu_torch.entry.run_dynamic --config configs/dynamic.yaml --mode "$MODE" "$@"
done
echo "[INFO] Dynamic inference finished"
