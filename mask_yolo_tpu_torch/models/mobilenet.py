"""Truncated MobileNetV1 backbone — port of `mask_yolo_tpu/models/mobilenet.py`.

3×3/s2 stem (32ch) + six depthwise-separable blocks (64, 64/s2, 128, 256/s2,
256, 512): a stride-8 feature map, 28×28×512 at 224² input.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvBN, DepthwiseSeparable

# (features, stride) of block1..block6
_BLOCKS = ((64, 1), (64, 2), (128, 1), (256, 2), (256, 1), (512, 1))


class MobileNetBackbone(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBN(3, 32, 3, 2, dtype=dtype)
        cin = 32
        for i, (features, stride) in enumerate(_BLOCKS, start=1):
            self.add_module(f"block{i}", DepthwiseSeparable(cin, features, stride, dtype))
            cin = features
        self.out_channels = cin

    def forward(self, x):
        """x: NCHW image → [B, 512, H/8, W/8]."""
        x = self.conv1(x)
        for i in range(1, len(_BLOCKS) + 1):
            x = getattr(self, f"block{i}")(x)
        return x
