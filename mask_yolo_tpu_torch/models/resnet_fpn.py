"""ResNet-50 + FPN backbone — port of `mask_yolo_tpu/models/resnet_fpn.py`.

Bottleneck ResNet-50 stages C2..C5 (3-4-6-3 blocks of 64/128/256/512 inner
width, ×4 out), a top-down FPN that fuses C5, C4 and C3 into P5, P4 and P3
(`pyramid_size` wide), and a 1×1 projection of P3 to 512 channels at stride
8: the MobileNet backbone's output contract (28×28×512 at 224²), so the
neck, the YOLO head and the mask branch take either.

As in the flax module:
  * the stride of a block sits on its 1×1 `conv1` (ResNet v1), not on the
    3×3 `conv2` as in v1.5 and torchvision's resnet50;
  * a block projects its residual (`proj`, `proj_bn`) only where the
    residual's shape differs from the branch's: block 0 of every stage,
    `c2_block0` (64 → 256 at stride 1) included;
  * padding is flax "SAME" throughout (`SameConv2d`); the 3×3/s2 max pool
    pads 0 before and 1 after with −inf, as `nn.max_pool` does. Its input
    comes after a relu, so zeros would give the same maximum, but −inf is
    what the flax op pads with and holds for any input;
  * convolutions compute in the compute dtype, BatchNorm in f32, so block
    outputs and residual sums are f32 in a bf16 network; the laterals, the
    nearest 2× upsample, the top-down adds, `smooth3` and `out_proj` run in
    the compute dtype (the adds round to bf16 in a bf16 network). The
    laterals, `smooth3` and `out_proj` have biases, the block convs none.

Submodule names are the flax names (`stem_conv`, `stem_bn`,
`c{2..5}_block{i}` with `conv1..3`, `bn1..3`, `proj`, `proj_bn`, `lat3..5`,
`smooth3`, `out_proj`), so `weights.from_jax_variables` maps them by path.
On a mesh each conv's output is gathered over the model group after its
BatchNorm (`gathered`), before the residual add and the top-down adds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import SameConv2d, batch_norm, gathered

# (stage, blocks, inner width)
STAGES = (("c2", 3, 64), ("c3", 4, 128), ("c4", 6, 256), ("c5", 3, 512))
EXPANSION = 4


class Bottleneck(nn.Module):
    """1×1 (stride) → 3×3 → 1×1 ×4, each followed by BatchNorm, relu after
    the first two and after the residual add."""

    def __init__(self, cin, features, stride=1, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, param_dtype=param_dtype)
        self.conv1 = SameConv2d(cin, features, 1, stride, **kw)
        self.bn1 = batch_norm(features)
        self.conv2 = SameConv2d(features, features, 3, **kw)
        self.bn2 = batch_norm(features)
        self.conv3 = SameConv2d(features, features * EXPANSION, 1, **kw)
        self.bn3 = batch_norm(features * EXPANSION)
        if stride != 1 or cin != features * EXPANSION:
            self.proj = SameConv2d(cin, features * EXPANSION, 1, stride, **kw)
            self.proj_bn = batch_norm(features * EXPANSION)
        else:
            self.proj = None

    def forward(self, x):
        y = gathered(self.conv1, torch.relu(self.bn1(self.conv1(x).float())))
        y = gathered(self.conv2, torch.relu(self.bn2(self.conv2(y).float())))
        y = gathered(self.conv3, self.bn3(self.conv3(y).float()))
        residual = x if self.proj is None else gathered(
            self.proj, self.proj_bn(self.proj(x).float()))
        return torch.relu(y + residual)


def _max_pool_3x3_s2(x):
    """flax `nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")` on NCHW."""
    n_h, n_w = x.shape[-2:]
    pads = []
    for n in (n_w, n_h):            # F.pad order: W then H
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


def _upsample2x(x):
    """Nearest-neighbour 2× upsample of NCHW `x`."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResNetFPNBackbone(nn.Module):
    """ResNet-50 stages + FPN → a stride-8 map of `out_channels` (512)."""

    out_channels = 512

    def __init__(self, pyramid_size=256, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.stem_conv = SameConv2d(3, 64, 7, 2, bias=False, **kw)
        self.stem_bn = batch_norm(64)
        cin = 64
        widths = {}
        for stage, n, width in STAGES:
            for i in range(n):
                stride = 2 if i == 0 and stage != "c2" else 1
                self.add_module(f"{stage}_block{i}", Bottleneck(cin, width, stride, **kw))
                cin = width * EXPANSION
            widths[stage] = cin
        self.lat3 = SameConv2d(widths["c3"], pyramid_size, 1, **kw)
        self.lat4 = SameConv2d(widths["c4"], pyramid_size, 1, **kw)
        self.lat5 = SameConv2d(widths["c5"], pyramid_size, 1, **kw)
        self.smooth3 = SameConv2d(pyramid_size, pyramid_size, 3, **kw)
        self.out_proj = SameConv2d(pyramid_size, self.out_channels, 1, **kw)

    def forward(self, x, return_pyramid: bool = False):
        """x: NCHW image → [B, 512, H/8, W/8] in the compute dtype; with
        return_pyramid also the (P3, P4, P5) NCHW maps (strides 8, 16, 32,
        `pyramid_size` channels each) for multi-level ROIAlign."""
        x = gathered(self.stem_conv, torch.relu(self.stem_bn(self.stem_conv(x).float())))
        x = _max_pool_3x3_s2(x)
        feats = {}
        for stage, n, _ in STAGES:
            for i in range(n):
                x = getattr(self, f"{stage}_block{i}")(x)
            feats[stage] = x

        def lateral(conv, f):
            return gathered(conv, conv(f))

        p5 = lateral(self.lat5, feats["c5"])
        p4 = lateral(self.lat4, feats["c4"]) + _upsample2x(p5)
        p3 = lateral(self.lat3, feats["c3"]) + _upsample2x(p4)
        p3 = gathered(self.smooth3, self.smooth3(p3))
        out = gathered(self.out_proj, torch.relu(self.out_proj(p3)))
        if return_pyramid:
            return out, (p3, p4, p5)
        return out

