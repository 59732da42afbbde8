#!/bin/bash
# Supervised finetune, 4-mode comparison
# PyTorch port: on the card by default; pass --device cpu to run on the CPU
set -e
echo "[INFO] Running supervised fine-tuning (4-mode comparison)"
for MODE in ft_random linear_probe ft_ssl two_stage; do
  echo "[INFO] mode=$MODE"
  python -m ssl_vit_video_analytics_tpu_torch.entry.train_finetune --config configs/finetune.yaml --mode "$MODE" "$@"
done
echo "[INFO] Finetuning finished"
