"""Mask branch — port of `mask_yolo_tpu/models/mask_head.py`.

ROI crop → four 3×3 conv+BN+relu → 2×2/s2 transposed conv + relu → 1×1 conv
to per-class logits → sigmoid. The (batch, roi) axes are folded into one
leading dim so each layer is one batched convolution.

The crop goes through `ops.roi_crop.crop_rois`: the hand-written CUDA kernel
on GPU tensors, its plain PyTorch twin on CPU tensors. Given the FPN
pyramid (P3, P4, P5) instead of one map, each ROI is pooled from its level
(`ops.roi_crop.multilevel_crop_rois`, one kernel call a level), with P4 as
FPN's k0 (`roi_align.CANONICAL_LEVEL`) and the network's `image_hw` for
the ROIs' pixel sizes; the crops, in the pyramid's dtype, are then cast to
the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.roi_crop import crop_rois, multilevel_crop_rois
from .layers import ConvTranspose2d, SameConv2d, batch_norm, gathered

CONV_FEATURES = 256


class MaskHead(nn.Module):
    def __init__(self, cin, num_classes, pool_size=14, dtype=torch.float32,
                 param_dtype=None, image_hw=(224, 224)):
        super().__init__()
        self.num_classes, self.pool_size, self.dtype = num_classes, pool_size, dtype
        self.image_hw = tuple(image_hw)
        for i in range(1, 5):
            self.add_module(f"mask_conv{i}", SameConv2d(
                cin if i == 1 else CONV_FEATURES, CONV_FEATURES, 3, dtype=dtype,
                param_dtype=param_dtype))
            self.add_module(f"mask_bn{i}", batch_norm(CONV_FEATURES))
        self.mask_deconv = ConvTranspose2d(CONV_FEATURES, CONV_FEATURES, 2, stride=2,
                                           dtype=dtype, param_dtype=param_dtype)
        self.mask_out = SameConv2d(CONV_FEATURES, num_classes, 1, dtype=dtype,
                                   param_dtype=param_dtype)

    def forward(self, rois, feature_map):
        """rois: [B, R, 4] normalized (x1, y1, x2, y2); feature_map:
        [B, h, w, C], or the FPN pyramid's maps fine to coarse →
        [B, R, 2·pool, 2·pool, num_classes] sigmoid masks."""
        rois = rois.float().contiguous()
        if isinstance(feature_map, (tuple, list)):
            crops = multilevel_crop_rois(feature_map, rois, self.pool_size,
                                         self.image_hw).to(self.dtype)
        else:
            crops = crop_rois(feature_map.to(self.dtype).contiguous(), rois, self.pool_size)
        return self.from_crops(crops)

    def from_crops(self, crops):
        """The conv stack on [B, R, pool, pool, C] crops in the compute dtype
        → [B, R, 2·pool, 2·pool, num_classes] sigmoid masks."""
        b, r, p = crops.shape[:3]
        x = crops.reshape(b * r, p, p, crops.shape[-1]).permute(0, 3, 1, 2)
        for i in range(1, 5):
            conv = getattr(self, f"mask_conv{i}")
            bn = getattr(self, f"mask_bn{i}")
            x = gathered(conv, torch.relu(bn(conv(x).float())))   # BN in f32, as in flax
        x = gathered(self.mask_deconv, torch.relu(self.mask_deconv(x)))
        x = torch.sigmoid(gathered(self.mask_out, self.mask_out(x)).float())
        side = 2 * p
        return x.permute(0, 2, 3, 1).reshape(b, r, side, side, self.num_classes)
