"""The ROI crop of the mask path: a hand-written CUDA kernel on GPU tensors.

`crop_rois` replaces the TPU kernel `mask_yolo_tpu/ops/pallas_crop.py::crop_rois`
(K2). On a CUDA tensor it launches `csrc/crop_rois.cu` or raises; on a CPU
tensor it runs the plain twin `roi_align.crop_and_resize`. The twin is the
kernel's reference, never its fallback: there is no path from a CUDA tensor
to it.

`crop_rois.launches` counts kernel launches (CPU calls do not count), so a
run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .roi_align import crop_and_resize

_SYMBOLS = {torch.float32: "crop_rois_f32", torch.bfloat16: "crop_rois_bf16"}


def _kernel(dtype):
    fn = getattr(_build.load("crop_rois"), _SYMBOLS[dtype])
    # fmap, boxes, out, B, H, W, C, K, P, stream
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def crop_rois(fmap, boxes, pool: int):
    """Bilinear crop of K ROIs per image (tf.image.crop_and_resize).

    fmap: [B, H, W, C] float32 or bfloat16; boxes: [B, K, 4] float32
    normalized (x1, y1, x2, y2). Returns [B, K, pool, pool, C] in the fmap's
    dtype. Samples outside the map are 0. Inference only: the kernel has no
    backward.
    """
    if fmap.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.shape[0] != fmap.shape[0]:
        raise ValueError(f"expected fmap [B, H, W, C] and boxes [B, K, 4], got "
                         f"{tuple(fmap.shape)} and {tuple(boxes.shape)}")
    if fmap.dtype not in _SYMBOLS:
        raise TypeError(f"fmap must be float32 or bfloat16, got {fmap.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if fmap.device != boxes.device:
        raise ValueError(f"fmap on {fmap.device} but boxes on {boxes.device}")
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    if fmap.device.type == "cpu":
        return crop_and_resize(fmap, boxes, (pool, pool))
    if fmap.device.type != "cuda":
        raise ValueError(f"crop_rois runs on cpu or cuda tensors, got {fmap.device}")
    if not (fmap.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("crop_rois needs contiguous fmap and boxes")
    if torch.is_grad_enabled() and fmap.requires_grad:
        raise NotImplementedError("the crop kernel has no backward")
    b, h, w, c = fmap.shape
    k = boxes.shape[1]
    out = torch.empty((b, k, pool, pool, c), dtype=fmap.dtype, device=fmap.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(fmap.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(fmap.dtype)(fmap.data_ptr(), boxes.data_ptr(), out.data_ptr(),
                                 b, h, w, c, k, pool, stream)
    if rc != 0:
        raise RuntimeError(f"crop_rois kernel launch failed with CUDA error {rc}")
    crop_rois.launches += 1
    return out


crop_rois.launches = 0
