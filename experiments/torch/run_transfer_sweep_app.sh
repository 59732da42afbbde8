#!/bin/bash
# SSL-transfer crossover hunt on an APPEARANCE-CODED fixture.
#
# The motion-only fixture is structurally untransferable for pipeline-B:
# its encoder is per-frame (masking happens AFTER encoding, models/mae.py),
# so MAE features cannot carry the class signal when classes differ only by
# trajectory. With appearance_signal=0.6 the sprite color is partly
# class-coded — per-frame features CAN carry label-relevant signal, and the
# linear_probe cells measure directly how much.
#
# Flow: pretrain pipeline-A and pipeline-B ON the appearance fixture, then
# equal-budget finetunes at 10% / 5% labels for both checkpoint families.
# PyTorch port: a pretraining whose .pt checkpoint exists is not run again
set -e
cd "$(dirname "$0")/../.."

DATA=${DATA:-/tmp/ssl_campaign/data_app}
APP=${APP:-0.6}
OUT=${OUT:-results/sweep_r4_app}
FRACS=${FRACS:-"0.10 0.05"}
MODES=${MODES:-"ft_random,ft_ssl,linear_probe,two_stage"}
EPOCHS=${EPOCHS:-30}
SSL_EPOCHS=${SSL_EPOCHS:-60}

if [ ! -f "$OUT/ssl_a/ssl/ssl_epoch_${SSL_EPOCHS}.pt" ]; then
  echo "=== [app-sweep] pipeline-A pretrain on appearance fixture ==="
  python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign \
    --out "$OUT/ssl_a" --data "$DATA" --appearance "$APP" \
    --ssl_epochs "$SSL_EPOCHS" --modes "" --skip_privacy
fi
if [ ! -f "$OUT/mae_b/ckpt/ckpt_epoch_${SSL_EPOCHS}.pt" ]; then
  echo "=== [app-sweep] pipeline-B MAE pretrain on appearance fixture ==="
  python -m ssl_vit_video_analytics_tpu_torch.scripts.mae_evidence \
    --out "$OUT/mae_b" --data "$DATA" --appearance "$APP" \
    --epochs "$SSL_EPOCHS" --log_interval 5
fi

for frac in $FRACS; do
  tag=$(printf 'lab%02d' "$(python -c "print(round($frac*100))")")
  echo "=== [app-sweep] pipeline-A backbone, ${frac} labels ==="
  python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign \
    --out "$OUT/A_${tag}" --data "$DATA" --appearance "$APP" \
    --skip_ssl --skip_privacy \
    --ssl_ckpt "$OUT/ssl_a/ssl/ssl_epoch_${SSL_EPOCHS}" \
    --backbone mobilevit_s \
    --ft_label_fraction "$frac" --ft_epochs "$EPOCHS" --modes "$MODES"
  echo "=== [app-sweep] pipeline-B backbone, ${frac} labels ==="
  python -m ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign \
    --out "$OUT/B_${tag}" --data "$DATA" --appearance "$APP" \
    --skip_ssl --skip_privacy \
    --ssl_ckpt "$OUT/mae_b/ckpt/ckpt_epoch_${SSL_EPOCHS}" \
    --backbone tinyvit \
    --ft_label_fraction "$frac" --ft_epochs "$EPOCHS" --modes "$MODES"
done
echo "[app-sweep] done"
