"""Shared NN building blocks — port of `mask_yolo_tpu/models/layers.py`.

Layout: modules take and return NCHW tensors in `torch.channels_last` memory,
so the NHWC views the public functions hand out are free `permute`s.

Precision follows the flax modules: convolutions run in the compute dtype,
BatchNorm runs in float32 (its statistics too, whatever the input's dtype).
flax keeps f32 parameters (`param_dtype=float32`) and casts them to the
compute dtype at each use. A network built with `param_dtype=float32` does
the same: its conv parameters are f32 masters, cast where they are used, so
autograd hands f32 gradients to them (bf16 training). By default the
parameters are created in the compute dtype instead, which rounds
identically and pays no cast per call: the inference network.

BatchNorm follows flax's `nn.BatchNorm` in train mode too (`BatchNorm`).

Padding follows flax "SAME": at stride 1 a 3×3 pads 1 on each side, at
stride 2 on an even input it pads 0 before and 1 after, which torch's
symmetric `padding=` cannot express — `same_pad` applies it explicitly.

On a mesh (parallel/mesh.place_network) two things change, and off one
neither does:
  * a BatchNorm in train mode sums its batch mean and E[x²] over the data
    group (`data_group`) before it uses them, through an all-reduce that
    carries gradients, so the statistics and their gradients are the global
    batch's, as the JAX package's GSPMD step computes them; the running
    statistics move by those global values;
  * a wide conv (`tp`, a `TensorParallel`) holds its rank's share of the
    output channels: its input enters the model group (the identity, whose
    gradient is summed over the group), a depthwise conv then takes its
    share of the input channels, and the block gathers the output over the
    group after its BatchNorm and activation (`gathered`), which run on the
    rank's channels with the rank's parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives

BN_EPS = 1e-3        # flax nn.BatchNorm(epsilon=1e-3)
BN_MOMENTUM = 0.01   # flax momentum 0.99 is torch momentum 0.01


def relu6(x):
    """relu capped at 6. Under autograd it is JAX's minimum(maximum(x, 0), 6),
    whose gradient at a tie (x exactly 0 or 6, common after an all-zero
    depthwise window) is 1/2, as torch.maximum/minimum give it; torch.clamp
    would pass the whole gradient there."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, 0.0, 6.0)
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


def same_pad(x, kernel: int, stride: int):
    """Pad NCHW `x` the way flax/XLA "SAME" does for a square `kernel` at
    `stride`: total = max((ceil(n/s) - 1)·s + k - n, 0), the smaller half
    before."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):   # F.pad order: W then H
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TensorParallel:
    """A conv's share of its output channels over a model group: rank
    `index` of `size` holds channels [index·n, (index+1)·n) of `channels`,
    n = channels / size."""

    def __init__(self, group, index: int, size: int, channels: int):
        self.group, self.index, self.size, self.channels = group, index, size, channels
        self.lo = index * (channels // size)

    def enter(self, x, depthwise: bool):
        """The conv's NCHW input: in the model group, and its own input
        channels for a depthwise conv."""
        x = collectives.enter_group(x, self.group)
        if depthwise:
            x = x[:, self.lo:self.lo + self.channels // self.size]
        return x

    def gather(self, x):
        return collectives.gather_channels(x, self.group, self.lo)


def gathered(conv, x):
    """x, the block output of `conv`'s channels, gathered over its model
    group where the conv is tensor-parallel (x itself otherwise)."""
    return x if conv.tp is None else conv.tp.gather(x)


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with flax "SAME" padding. Stride 1 pads symmetrically inside
    the convolution; stride 2 pads explicitly (0 before, 1 after on even
    inputs). `tp`: its TensorParallel share on a mesh (None off one)."""

    tp = None

    def __init__(self, cin, cout, kernel, stride=1, groups=1, bias=True,
                 dtype=torch.float32, param_dtype=None):
        self.same_stride = stride
        self.compute_dtype = dtype
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=(kernel - 1) // 2 if stride == 1 else 0,
                         groups=groups, bias=bias, dtype=param_dtype or dtype)

    def forward(self, x):
        if self.tp is not None:
            x = self.tp.enter(x, depthwise=self.groups > 1)
        x = x.to(self.compute_dtype)
        if self.same_stride != 1:
            x = same_pad(x, self.kernel_size[0], self.same_stride)
        return self._conv_forward(x, *cast_params(self, self.compute_dtype))


def cast_params(conv, dtype):
    """(weight, bias) of a conv module in `dtype`: the parameters themselves
    where they are held in it, casts that autograd sees otherwise."""
    bias = conv.bias
    return conv.weight.to(dtype), None if bias is None else bias.to(dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in `dtype` on parameters held in
    `param_dtype` (default: `dtype`). `tp` as SameConv2d's."""

    tp = None

    def __init__(self, cin, cout, kernel, stride, dtype=torch.float32, param_dtype=None):
        self.compute_dtype = dtype
        super().__init__(cin, cout, kernel, stride=stride, dtype=param_dtype or dtype)

    def forward(self, x):
        if self.tp is not None:
            x = self.tp.enter(x, depthwise=False)
        weight, bias = cast_params(self, self.compute_dtype)
        return F.conv_transpose2d(x.to(self.compute_dtype), weight, bias, self.stride)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with flax `nn.BatchNorm(momentum=0.99, epsilon=1e-3)`
    semantics.

    Eval mode is nn.BatchNorm2d's (running statistics). Train mode computes
    the batch mean and the *biased* variance E[x²] − E[x]² (clamped at 0) in
    float32 over (N, H, W), normalizes with them as flax does,
    (x − mean)·(rsqrt(var + eps)·scale) + bias, and moves the running
    statistics by ra = 0.99·ra + 0.01·stat with that same biased variance.
    (nn.BatchNorm2d would update `running_var` with the unbiased n/(n−1)
    variance, 14 % too large at 8 samples.) With a `data_group` (on a mesh),
    the mean and E[x²] are those of the group's whole batch (each rank's
    batch of one size).
    """

    data_group = None

    def __init__(self, num_features):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        x = x.float()
        dims = (0, 2, 3)
        mean = x.mean(dims)
        square = (x * x).mean(dims)
        if self.data_group is not None:
            n = torch.distributed.get_world_size(self.data_group)
            mean, square = collectives.all_reduce_sum(torch.stack([mean, square]),
                                                      self.data_group) / n
        var = torch.clamp(square - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean * self.momentum)
            self.running_var.mul_(keep).add_(var * self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def batch_norm(num_features):
    return BatchNorm(num_features)


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm + relu6 (flax `ConvBN`: children `conv`,
    `bn`)."""

    def __init__(self, cin, features, kernel=3, stride=1, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        self.conv = SameConv2d(cin, features, kernel, stride, bias=False,
                               dtype=dtype, param_dtype=param_dtype)
        self.bn = batch_norm(features)

    def forward(self, x):
        return gathered(self.conv, relu6(self.bn(self.conv(x).float())))   # BN in f32, as in flax


class DepthwiseSeparable(nn.Module):
    """MobileNetV1 block: 3×3 depthwise conv + BN + relu6, then 1×1 pointwise
    conv + BN + relu6 (flax children `conv_dw`, `conv_dw_bn`, `conv_pw`,
    `conv_pw_bn`)."""

    def __init__(self, cin, features, stride=1, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.conv_dw = SameConv2d(cin, cin, 3, stride, groups=cin, bias=False,
                                  dtype=dtype, param_dtype=param_dtype)
        self.conv_dw_bn = batch_norm(cin)
        self.conv_pw = SameConv2d(cin, features, 1, bias=False, dtype=dtype,
                                  param_dtype=param_dtype)
        self.conv_pw_bn = batch_norm(features)

    def forward(self, x):
        x = gathered(self.conv_dw, relu6(self.conv_dw_bn(self.conv_dw(x).float())))
        return gathered(self.conv_pw, relu6(self.conv_pw_bn(self.conv_pw(x).float())))
