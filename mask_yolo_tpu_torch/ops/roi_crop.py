"""The ROI crop of the mask path: a hand-written CUDA kernel on GPU tensors,
forward and backward.

`crop_rois` replaces the TPU kernel `mask_yolo_tpu/ops/pallas_crop.py::crop_rois`
(K2). On a CUDA tensor it launches `csrc/crop_rois.cu` or raises; on a CPU
tensor it runs the plain twin `roi_align.crop_and_resize`. The twin is the
kernel's reference, never its fallback: there is no path from a CUDA tensor
to it.

For training, an f32 fmap that requires grad goes through an
`autograd.Function` whose backward is `crop_rois_backward`: the kernel
`crop_rois_backward_f32` on CUDA tensors, the twin
`roi_align.crop_and_resize_backward` on CPU tensors. The boxes get no
gradient, as in JAX (`roi_align.crop_and_resize` stops it). bf16 training is
not ported, so a bf16 fmap that requires grad raises.

`crop_rois.launches` and `crop_rois_backward.launches` count kernel launches
(CPU calls do not count), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .roi_align import crop_and_resize, crop_and_resize_backward

_SYMBOLS = {torch.float32: "crop_rois_f32", torch.bfloat16: "crop_rois_bf16"}


def _kernel(symbol, n_ptrs=3):
    fn = getattr(_build.load("crop_rois"), symbol)
    # pointers (in, boxes, [scratch,] out), B, H, W, C, K, P, stream
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol, tensors, b, h, w, c, k, pool):
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(symbol, len(tensors))(*(t.data_ptr() for t in tensors),
                                           b, h, w, c, k, pool, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error {rc}")


def _check(name, t, boxes):
    if t.device != boxes.device:
        raise ValueError(f"{name} on {t.device} but boxes on {boxes.device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")
    if t.device.type == "cuda" and not (t.is_contiguous() and boxes.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors on cuda")


def _forward(fmap, boxes, pool):
    if fmap.device.type == "cpu":
        return crop_and_resize(fmap, boxes, (pool, pool))
    b, h, w, c = fmap.shape
    k = boxes.shape[1]
    out = torch.empty((b, k, pool, pool, c), dtype=fmap.dtype, device=fmap.device)
    if out.numel():
        _launch(_SYMBOLS[fmap.dtype], (fmap, boxes, out), b, h, w, c, k, pool)
        crop_rois.launches += 1
    return out


class _CropRois(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fmap, boxes, pool):
        ctx.save_for_backward(boxes)
        ctx.fmap_hw = tuple(fmap.shape[1:3])
        return _forward(fmap, boxes, pool)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        return crop_rois_backward(grad.contiguous(), boxes, ctx.fmap_hw), None, None


def crop_rois(fmap, boxes, pool: int):
    """Bilinear crop of K ROIs per image (tf.image.crop_and_resize).

    fmap: [B, H, W, C] float32 or bfloat16; boxes: [B, K, 4] float32
    normalized (x1, y1, x2, y2). Returns [B, K, pool, pool, C] in the fmap's
    dtype. Samples outside the map are 0. Differentiable in the f32 fmap
    (not in the boxes).
    """
    if fmap.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.shape[0] != fmap.shape[0]:
        raise ValueError(f"expected fmap [B, H, W, C] and boxes [B, K, 4], got "
                         f"{tuple(fmap.shape)} and {tuple(boxes.shape)}")
    if fmap.dtype not in _SYMBOLS:
        raise TypeError(f"fmap must be float32 or bfloat16, got {fmap.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    _check("fmap", fmap, boxes)
    if not (torch.is_grad_enabled() and fmap.requires_grad):
        return _forward(fmap, boxes, pool)
    if fmap.dtype != torch.float32:
        raise NotImplementedError(
            "the crop's backward is f32 only: bf16 training is not ported "
            "(ROADMAP Queue 1, bf16 training with f32 master weights)")
    return _CropRois.apply(fmap, boxes.detach(), pool)


def crop_rois_backward(grad, boxes, fmap_hw):
    """Gradient of `crop_rois` with respect to an f32 fmap: grad
    [B, K, P, P, C] float32, boxes [B, K, 4] float32 → d_fmap [B, H, W, C].
    The kernel takes maps up to 192 wide."""
    if grad.dim() != 5 or grad.shape[2] != grad.shape[3] or boxes.dim() != 3 \
            or tuple(boxes.shape) != (grad.shape[0], grad.shape[1], 4):
        raise ValueError(f"expected grad [B, K, P, P, C] and boxes [B, K, 4], got "
                         f"{tuple(grad.shape)} and {tuple(boxes.shape)}")
    if grad.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"grad and boxes must be float32, got {grad.dtype}, {boxes.dtype}")
    _check("grad", grad, boxes)
    h, w = fmap_hw
    if grad.device.type == "cpu":
        return crop_and_resize_backward(grad, boxes, (h, w))
    b, k, pool, _, c = grad.shape
    if k * pool == 0:   # no samples: the tap kernel would launch an empty grid
        return torch.zeros((b, h, w, c), dtype=torch.float32, device=grad.device)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=grad.device)
    if out.numel():
        taps = torch.empty((b * k * pool * 2, 4), dtype=torch.int32, device=grad.device)
        _launch("crop_rois_backward_f32", (grad, boxes, taps, out), b, h, w, c, k, pool)
        crop_rois_backward.launches += 1
    return out


crop_rois.launches = 0
crop_rois_backward.launches = 0
