"""The Mask-YOLO network — port of `mask_yolo_tpu/models/network.py`.

    C4   = backbone(image)                       # [B, 28, 28, 512]
    fmap = Conv3x3(C4) -> TOP_FEATURE_MAP_DEPTH  # neck
    grid = yolo_head(C4)                         # [B, gh, gw, nb, 5+C]
    masks = mask_head(rois, fmap)                # [B, R, 28, 28, C]

The ResNet-50 + FPN backbone (`backbone="resnet50_fpn"`) keeps that
contract for the YOLO head, and its (P3, P4, P5) pyramid, as wide as the
neck (`top_feature_map_depth`), feeds the mask branch through multi-level
ROIAlign instead of the neck (`trunk_pyramid`, `pick_trunk`); the neck still
exists on that network, but no FPN path reads it.

Submodule names equal the flax module names, so a flax variable path maps to
a torch state_dict key by joining with dots (`weights.from_jax_variables`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import SameConv2d, gathered
from .mask_head import MaskHead
from .mobilenet import MobileNetBackbone
from .resnet_fpn import ResNetFPNBackbone
from .yolo_head import YoloHead

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MaskYoloNet(nn.Module):
    def __init__(self, num_classes, n_box, top_feature_map_depth=256,
                 mask_pool_size=14, backbone="mobilenet",
                 compute_dtype="float32", param_dtype=None, image_hw=(224, 224)):
        """param_dtype: the dtype the conv parameters are held in (default:
        the compute dtype). "float32" with a bfloat16 compute dtype gives
        the training network: f32 masters cast at each use, as flax keeps
        them (models/layers.py). image_hw: the input's pixel size, which
        the FPN mask branch's level assignment reads."""
        super().__init__()
        dt = DTYPES[compute_dtype]
        pdt = DTYPES[param_dtype or compute_dtype]
        self.backbone_name = backbone
        if backbone == "mobilenet":
            self.backbone = MobileNetBackbone(dtype=dt, param_dtype=pdt)
        elif backbone == "resnet50_fpn":
            self.backbone = ResNetFPNBackbone(pyramid_size=top_feature_map_depth, dtype=dt,
                                              param_dtype=pdt)
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        c4 = self.backbone.out_channels
        # neck: reduce depth for the mask branch only
        self.feature_map = SameConv2d(c4, top_feature_map_depth, 3, dtype=dt,
                                      param_dtype=pdt)
        self.yolo = YoloHead(c4, n_box, num_classes, dtype=dt, param_dtype=pdt)
        self.mask = MaskHead(top_feature_map_depth, num_classes, mask_pool_size,
                             dtype=dt, param_dtype=pdt, image_hw=image_hw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Seeded random weights for the inference smoke runs: He-normal conv
        kernels, zero biases, identity BatchNorm. He-normal keeps the activations' scale through the
        net's ReLUs, so an untrained net still gives spread scores and masks
        (flax's LeCun-normal default shrinks them toward logit 0). Draws on
        the CPU generator, so a seed gives the same weights on every device."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                # fan_in over the kernel's input axis: dim 1 for Conv2d
                # [O, I/g, kh, kw], dim 0 for ConvTranspose2d [I, O, kh, kw]
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                std = math.sqrt(2.0 / (cin * w.shape[2] * w.shape[3]))
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    @torch.no_grad()
    def init_flax_defaults(self, generator: torch.Generator):
        """Seeded weights drawn as flax's default initializers draw them (the
        JAX package's `net.init`, which training from scratch starts from):
        LeCun-normal conv kernels, truncated at ±2 std (std =
        sqrt(1/fan_in)/0.8796, fan_in = kh·kw·in/groups), zero biases, unit
        BatchNorm scales and running variances, zero shifts and means. Draws
        on the CPU generator, so a seed gives the same weights on every
        device. (The numbers differ from jax.random's for the same seed.)"""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                std = math.sqrt(1.0 / (cin * w.shape[2] * w.shape[3])) / 0.87962566103423978
                draw = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
                w.copy_(draw * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def trunk(self, image):
        """image [B, H, W, 3] float in [0, 1] → (grid [B, gh, gw, nb, 5+C]
        float32, fmap [B, h, w, C] in the compute dtype)."""
        c4 = self.backbone(_nchw(image))
        fmap = gathered(self.feature_map, self.feature_map(c4))
        return self.yolo(c4), fmap.permute(0, 2, 3, 1)

    def trunk_pyramid(self, image):
        """The FPN network's trunk: image → (grid, (P3, P4, P5) [B, h, w, C]
        in the compute dtype, fine to coarse), the pyramid that the mask
        branch pools each ROI from by its level."""
        if self.backbone_name != "resnet50_fpn":
            raise ValueError("trunk_pyramid requires the resnet50_fpn backbone")
        c4, pyramid = self.backbone(_nchw(image), return_pyramid=True)
        return self.yolo(c4), tuple(p.permute(0, 2, 3, 1) for p in pyramid)

    def pick_trunk(self):
        """The trunk the training and detect paths use: `trunk_pyramid` on
        the FPN network, `trunk` (the neck's single map) otherwise."""
        return self.trunk_pyramid if self.backbone_name == "resnet50_fpn" else self.trunk

    def mask_branch(self, rois, fmap):
        """rois [B, R, 4] normalized, fmap one map or the pyramid →
        [B, R, 28, 28, C] sigmoid masks."""
        return self.mask(rois, fmap)


def _nchw(image):
    """[B, H, W, 3] → the NCHW channels_last view the backbones take."""
    return image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
