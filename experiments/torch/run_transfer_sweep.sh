#!/bin/bash
# SSL-transfer label-fraction sweep: hunt the regime where SSL pretraining
# beats from-scratch, for BOTH checkpoint families, at equal finetune budget
# on the 936-clip hard fixture.
#   pipeline A (MobileViT EMA-SSL ckpt)  -> backbone mobilevit_s
#   pipeline B (TinyViT MAE-200ep ckpt)  -> backbone tinyvit
# Fractions 25%/10%/5%; modes ft_random / ft_ssl / two_stage per cell.
# ~18 finetunes, serial, one card. Outputs under results/sweep_r4/.
# PyTorch port: checkpoints are the port's .pt files (A_CKPT, B_CKPT name
# them without the suffix)
set -e
cd "$(dirname "$0")/../.."

A_CKPT=${A_CKPT:-results/ssl_transfer_v2/ssl/ssl_epoch_60}
B_CKPT=${B_CKPT:-results/mae_evidence_200/ckpt/ckpt_epoch_200}
FRACS=${FRACS:-"0.25 0.10 0.05"}
MODES=${MODES:-"ft_random,ft_ssl,two_stage"}
EPOCHS=${EPOCHS:-30}

for frac in $FRACS; do
  tag=$(printf 'lab%02d' "$(python -c "print(round($frac*100))")")
  echo "=== [sweep] pipeline-A backbone, ${frac} labels ==="
  python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign \
    --out "results/sweep_r4/A_${tag}" --skip_ssl --skip_privacy \
    --ssl_ckpt "$A_CKPT" --backbone mobilevit_s \
    --ft_label_fraction "$frac" --ft_epochs "$EPOCHS" --modes "$MODES"
  echo "=== [sweep] pipeline-B backbone, ${frac} labels ==="
  python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign \
    --out "results/sweep_r4/B_${tag}" --skip_ssl --skip_privacy \
    --ssl_ckpt "$B_CKPT" --backbone tinyvit \
    --ft_label_fraction "$frac" --ft_epochs "$EPOCHS" --modes "$MODES"
done
echo "[sweep] done"
