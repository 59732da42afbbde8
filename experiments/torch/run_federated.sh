#!/bin/bash
# Federated FedAvg (a client mesh under torchrun)
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
echo "[INFO] Running federated learning"
python -m ssl_vit_video_analytics_tpu_torch.entry.run_federated --config configs/federated.yaml "$@"
echo "[INFO] Federated run finished"
