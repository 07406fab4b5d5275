"""Bilinear ROI crop and mask paste — port of `mask_yolo_tpu/ops/roi_align.py`.

`crop_and_resize` is the plain PyTorch twin of the CUDA crop kernel
(`ops/roi_crop.py`): the CPU path and the kernel's reference on the card.
It keeps the JAX package's separable form,

    crop[r] = Wy[r] @ image @ Wx[r]^T        (per channel)

with Wy [pool_h, H] and Wx [pool_w, W] bilinear "tent" matrices whose rows
are zero for samples outside the map (tf.image.crop_and_resize with
extrapolation_value=0), and rounds the weights and the intermediate to the
working dtype at the same points as the JAX version.

`crop_and_resize_backward` is the plain twin of the crop kernel's backward
(the gradient with respect to the feature map; boxes get none, as in JAX),
and `crop_and_resize_per_roi` the single-channel f32 crop that target
assignment uses on ground-truth masks.

`multilevel_crop_and_resize` is multi-level (FPN) ROIAlign: each ROI is
cropped from the pyramid level that `fpn_levels` assigns it (FPN eq. 1).
Its card form, one K2 launch a level, is `ops/roi_crop.multilevel_crop_rois`.
"""

from __future__ import annotations

import torch


def interp_matrix(lo, hi, in_size: int, out_size: int, dtype=torch.float32):
    """Bilinear interpolation matrices for a batch of 1-D spans.

    lo, hi: [...] normalized span start/end. Returns W [..., out_size,
    in_size]; row i holds the two tent weights of sample i, all zero if the
    sample lies outside [0, in_size - 1]. Sample coordinates:
    lo·n + (i / (P-1))·((hi - lo)·n) with n = in_size - 1, or
    0.5·(lo + hi)·n when P == 1. Weights are computed in f32 and only the
    result is cast to `dtype`.
    """
    lo = lo.float()
    hi = hi.float()
    n = in_size - 1
    dev = lo.device
    if out_size > 1:
        steps = torch.arange(out_size, dtype=torch.float32, device=dev) / (out_size - 1)
        coords = lo[..., None] * n + steps * ((hi - lo)[..., None] * n)
    else:
        coords = 0.5 * (lo + hi)[..., None] * n
    grid = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(coords[..., None] - grid), min=0.0)
    in_range = (coords >= 0.0) & (coords <= n)
    return (w * in_range[..., None].float()).to(dtype)


def crop_and_resize(feature, boxes, crop_size, dtype=None):
    """Batched bilinear crop: feature [B, H, W, C], boxes [B, R, 4]
    (x1, y1, x2, y2) normalized → [B, R, ph, pw, C] in `dtype` (default: the
    feature's dtype)."""
    ph, pw = crop_size
    b, h, w, c = feature.shape
    r = boxes.shape[1]
    dtype = feature.dtype if dtype is None else dtype
    x1, y1, x2, y2 = boxes.unbind(-1)
    wy = interp_matrix(y1, y2, h, ph, dtype)           # [B, R, ph, H]
    wx = interp_matrix(x1, x2, w, pw, dtype)           # [B, R, pw, W]
    feat = feature.to(dtype).reshape(b, h, w * c)
    tmp = torch.matmul(wy.reshape(b, r * ph, h), feat).reshape(b, r, ph, w, c)
    return torch.matmul(wx[:, :, None], tmp)           # [B, R, ph, pw, C]


def crop_and_resize_backward(grad, boxes, feature_hw):
    """Gradient of `crop_and_resize` (f32) with respect to its feature map:
    grad [B, R, ph, pw, C], boxes [B, R, 4] → d_feature [B, H, W, C], the
    transposed separable contraction Σ_r Wy[r]ᵀ · grad[r] · Wx[r]."""
    b, r, ph, pw, c = grad.shape
    h, w = feature_hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    wy = interp_matrix(y1, y2, h, ph, grad.dtype)      # [B, R, ph, H]
    wx = interp_matrix(x1, x2, w, pw, grad.dtype)      # [B, R, pw, W]
    tmp = torch.matmul(wx.transpose(-1, -2)[:, :, None], grad)   # [B, R, ph, W, C]
    d = torch.matmul(wy.reshape(b, r * ph, h).transpose(1, 2),
                     tmp.reshape(b, r * ph, w * c))    # [B, H, W·C]
    return d.reshape(b, h, w, c)


def crop_and_resize_per_roi(images, boxes, crop_size):
    """Single-channel crop of one image per ROI, in f32: images [R, H, W],
    boxes [R, 4] (x1, y1, x2, y2) normalized → [R, ph, pw]. Used for the
    mask targets (`ops/target_assign.py`)."""
    ph, pw = crop_size
    _, h, w = images.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    wy = interp_matrix(y1, y2, h, ph)                  # [R, ph, H]
    wx = interp_matrix(x1, x2, w, pw)                  # [R, pw, W]
    tmp = torch.bmm(wy, images.float())                # [R, ph, W]
    return torch.bmm(tmp, wx.transpose(1, 2))


# FPN eq. 1: an ROI of CANONICAL_SCALE pixels (whatever the image size) goes
# to pyramid index CANONICAL_LEVEL, FPN's k0 = 4 (P4) in (P3, P4, P5)
CANONICAL_SCALE, CANONICAL_LEVEL = 224.0, 1


def fpn_levels(boxes, n_levels: int, image_hw):
    """The pyramid level of each ROI (FPN eq. 1): boxes [..., 4] normalized
    (x1, y1, x2, y2) → int64 [...] in [0, n_levels - 1], fine to coarse:
    CANONICAL_LEVEL + round(log2(sqrt(bw·bh) / CANONICAL_SCALE)), each ×2 in
    scale one level coarser, with bw, bh = max(side, 1e-8) × the image's
    pixel size, in f32. torch.round rounds half to even, as jnp.round does."""
    h_px, w_px = image_hw
    boxes = boxes.float()
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-8) * w_px
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-8) * h_px
    level = CANONICAL_LEVEL + torch.round(torch.log2(torch.sqrt(bw * bh) / CANONICAL_SCALE))
    return torch.clamp(level, 0, n_levels - 1).long()


def select_levels(crops, level):
    """Each ROI's crop from its level: crops, one [B, R, ph, pw, C] a level,
    level [B, R] → [B, R, ph, pw, C]. An exact select, so the values and the
    gradients (zero for the levels not taken) are those of the JAX package's
    one-hot contraction."""
    out = crops[0]
    for i in range(1, len(crops)):
        out = torch.where((level == i)[..., None, None, None], crops[i], out)
    return out


def multilevel_crop_and_resize(features, boxes, crop_size, image_hw=(224, 224)):
    """Multi-level (FPN) ROIAlign, the plain version: features, the pyramid
    maps fine to coarse, each [B, Hi, Wi, C]; boxes [B, R, 4] normalized.
    Every level is cropped (in its own dtype) on all R boxes and each ROI
    takes the crop of its level (`fpn_levels`). Returns [B, R, ph, pw, C]."""
    level = fpn_levels(boxes, len(features), image_hw)
    return select_levels([crop_and_resize(f, boxes, crop_size) for f in features], level)


def paste_masks(masks, boxes, image_size, dtype=torch.float32):
    """Paste per-ROI masks back onto the image canvas (inverse of the crop).

    masks: [..., R, mh, mw]; boxes: [..., R, 4] (x1, y1, x2, y2) normalized.
    Returns [..., R, H, W]: each mask bilinearly resized into its box, zero
    elsewhere. For image pixel y the mask coordinate is
    (y/(H-1) - y1) / (y2 - y1) · (mh - 1). Coordinates are f32; the two
    contractions run in `dtype` (bf16 may flip borderline 0.5-threshold
    pixels on mask edges).
    """
    mh, mw = masks.shape[-2:]
    h, w = image_size
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    dev = masks.device

    def paste_matrix(lo, hi, out_size, m_size):
        pix = torch.arange(out_size, dtype=torch.float32, device=dev) / max(out_size - 1, 1)
        span = torch.clamp(hi - lo, min=1e-8)[..., None]
        coords = (pix - lo[..., None]) / span * (m_size - 1)   # [..., R, out]
        grid = torch.arange(m_size, dtype=torch.float32, device=dev)
        # pixels slightly past the box edge still belong to the outline;
        # clamp their sample coordinate to the border value
        inside = (coords >= -0.5) & (coords <= (m_size - 1) + 0.5)
        coords = torch.clamp(coords, 0.0, m_size - 1)
        wgt = torch.clamp(1.0 - torch.abs(coords[..., None] - grid), min=0.0)
        return (wgt * inside[..., None]).to(dtype)

    py = paste_matrix(y1, y2, h, mh)                   # [..., R, H, mh]
    px = paste_matrix(x1, x2, w, mw)                   # [..., R, W, mw]
    tmp = torch.matmul(py, masks.to(dtype))            # [..., R, H, mw]
    return torch.matmul(tmp, px.transpose(-1, -2))     # [..., R, H, W]
