"""YOLO detection branch — port of `mask_yolo_tpu/models/yolo_head.py`.

Eight more depthwise-separable blocks take the stride-8 map down to the
stride-32 grid (512/s2, 512 ×5, 1024/s2, 1024), then a 1×1 conv to
N_BOX·(5+NUM_CLASSES) channels reshaped to [B, gh, gw, nb, 5+C].
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import DepthwiseSeparable, SameConv2d, gathered

# (features, stride) of block7..block14
_BLOCKS = ((512, 2),) + ((512, 1),) * 5 + ((1024, 2), (1024, 1))


class YoloHead(nn.Module):
    def __init__(self, cin, n_box, num_classes, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.n_box, self.num_classes = n_box, num_classes
        for i, (features, stride) in enumerate(_BLOCKS, start=7):
            self.add_module(f"block{i}", DepthwiseSeparable(cin, features, stride, dtype,
                                                             param_dtype))
            cin = features
        self.conv_23 = SameConv2d(cin, n_box * (5 + num_classes), 1,
                                  dtype=dtype, param_dtype=param_dtype)

    def forward(self, x):
        """x: [B, 512, h, w] → grid [B, gh, gw, nb, 5+C] float32."""
        for i in range(7, 7 + len(_BLOCKS)):
            x = getattr(self, f"block{i}")(x)
        x = gathered(self.conv_23, self.conv_23(x)).permute(0, 2, 3, 1)   # NHWC view
        b, gh, gw, _ = x.shape
        # the raw grid stays in float32 for the decode math
        return x.reshape(b, gh, gw, self.n_box, 5 + self.num_classes).float()
