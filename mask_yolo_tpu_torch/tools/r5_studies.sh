#!/usr/bin/env bash
# The post-training studies on an 81-class checkpoint — port of the JAX
# package's tools/r5_studies.sh, the same five steps through the port's
# `python -m mask_yolo_tpu_torch.tools.*` entry points.
#
# All studies run on the best checkpoint of a quality_run_coco run (the AP
# callback's best-box_ap50 weights, or its final weights) and its held-out
# eval split.
#
# Usage (from the repository root):
#   bash mask_yolo_tpu_torch/tools/r5_studies.sh [weights] [data_dir] 2>&1 | tee r5_studies.log
#   DEVICE=cpu bash mask_yolo_tpu_torch/tools/r5_studies.sh ...   # --device for every tool
set -euo pipefail
cd "$(dirname "$0")/../.."

WEIGHTS=${1:-quality_run_coco/weights}
DATA=${2:-quality_run_coco/coco_eval}
DEVICE=${DEVICE:-cuda}
OUT=${OUT:-asset}
test -e "$WEIGHTS" || { echo "no weights at $WEIGHTS"; exit 1; }
mkdir -p "$OUT"

echo "=== [1/5] MASK_TOP_K 0/32/48 A/B ==="
python -m mask_yolo_tpu_torch.tools.eval_int8 --weights "$WEIGHTS" --data "$DATA" \
  --variants none --mask-top-k 0 32 48 --device "$DEVICE" \
  --out "$OUT/coco80_masktopk_port.json"

echo "=== [2/5] int8 mask-residual 7-variant sweep ==="
python -m mask_yolo_tpu_torch.tools.eval_int8 --weights "$WEIGHTS" --data "$DATA" \
  --variants f32 pc pc_qat pc_qat_mw pc_f32deconv pc_f32tail pc_qat_mw_f32deconv \
  --device "$DEVICE" --out "$OUT/coco80_int8_port.json"

echo "=== [3/5] infer_yolo compaction exactness on real data ==="
python -m mask_yolo_tpu_torch.tools.ab_infer_yolo_exactness --weights "$WEIGHTS" \
  --data "$DATA" --k 32 48 64 --top-n 256 --device "$DEVICE" \
  --out "$OUT/infer_yolo_exactness_port.json"

echo "=== [4/5] infer_yolo 416^2 stage profile ==="
python -m mask_yolo_tpu_torch.tools.profile_infer_yolo --batch 128 --weights "$WEIGHTS" \
  --device "$DEVICE" | tee "$OUT/infer_yolo_profile_port.txt"

echo "=== [5/5] overlay PNGs from the checkpoint ==="
python -m mask_yolo_tpu_torch.tools.predict --weights "$WEIGHTS" \
  --images "$DATA"/images --config coco \
  --out "$OUT/predictions_textured_port.json" \
  --batch-size 8 --score-threshold 0.35 \
  --overlays 3 --overlay-dir "$OUT" --device "$DEVICE"

echo "=== studies complete ==="
