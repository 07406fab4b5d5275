"""mask_yolo_tpu_torch — the PyTorch/CUDA port of `mask_yolo_tpu`.

It imports torch and never jax, flax or the JAX package. Module names mirror
`mask_yolo_tpu`, so each module's counterpart is easy to find. Public
functions keep the JAX package's layouts (images [B, H, W, 3], grid
[B, gh, gw, nb, 5+C], feature maps [B, h, w, C], boxes (x1, y1, x2, y2)
normalized) so parity tests compare like with like.

Ported so far: the float inference paths (`MaskYOLO(mode="inference")
.detect / .detect_batch / .infer_yolo`), the int8 path that serves all three
(`MaskYOLO.quantize`, `quant.py`), the serving executor, training in f32 and
in bf16 on f32 master weights (`MaskYOLO.train`, with augmentation, pooled
data workers and profiler traces) and evaluation (`evaluate_dataset`,
`make_ap_eval_callback`). Three hand-written CUDA kernels run on GPU
tensors: the ROI crop (`ops/roi_crop.py`, `csrc/crop_rois.cu`), the
fused int8 depthwise-separable block (`ops/ds_block.py`,
`csrc/fused_ds_block.cu`) and the fused int8 mask branch
(`ops/mask_fused.py`, `csrc/fused_mask_branch.cu`).
"""

from .config import Config, CocoStyleConfig
from .evaluate import evaluate_dataset, make_ap_eval_callback
from .model import MaskYOLO

__all__ = ["Config", "CocoStyleConfig", "MaskYOLO", "evaluate_dataset",
           "make_ap_eval_callback"]
