"""mask_yolo_tpu_torch — the PyTorch/CUDA port of `mask_yolo_tpu`.

It imports torch and never jax, flax or the JAX package. Module names mirror
`mask_yolo_tpu`, so each module's counterpart is easy to find. Public
functions keep the JAX package's layouts (images [B, H, W, 3], grid
[B, gh, gw, nb, 5+C], feature maps [B, h, w, C], boxes (x1, y1, x2, y2)
normalized) so parity tests compare like with like.

Ported so far: the float inference path (`MaskYOLO(mode="inference")
.detect / .detect_batch`) and the serving executor. The bilinear ROI crop on
that path runs as a hand-written CUDA kernel on GPU tensors
(`ops/roi_crop.py`, `csrc/crop_rois.cu`).
"""

from .config import Config, CocoStyleConfig
from .model import MaskYOLO

__all__ = ["Config", "CocoStyleConfig", "MaskYOLO"]
