"""Post-training int8 detect path — port of `mask_yolo_tpu/quant.py`.

Scheme (as in the JAX package):
  * BatchNorm is folded into the preceding conv's kernel and bias.
  * Weights: symmetric per-output-channel int8, scale = absmax / 127.
  * Activations: symmetric per-tensor int8 with static scales from one
    calibration pass (absmax of every layer's input over sample images).
  * Accumulation in int32, dequantized as acc·(w_scale·s_in) + bias in f32,
    activation, then requantized at the next layer's input scale, so the
    tensors between layers stay int8.
  * The mask deconv runs as a 1×1 conv to 4× channels plus depth-to-space;
    the class conv after it stays bf16 and consumes the (di, dj, o) layout
    block-diagonally.

Layouts follow the JAX package: NHWC activations, HWIO kernels, numpy in
the graph. The graph is built from a flax-layout f32 variable tree
(`weights.to_jax_variables` gives one for a torch model).

How the port computes each layer, and why:
  * int8 convs: im2col of the SAME-padded input, then `torch._int_mm`
    (`ops/int8.int_mm`): exact, so int32 accumulators equal XLA's.
  * int8 depthwise convs: nine shifted int32 multiply-adds (exact).
  * bf16 layers (a non-int8 depthwise, the stem at ≥ 320², `mask_out`):
    XLA multiplies bf16 operands and accumulates in f32 without rounding the
    result, so the port runs an f32 conv on bf16-rounded operands. Every f32
    conv here is an im2col matmul or shifted adds, never cuDNN, so TF32 can
    only enter through `torch.backends.cuda.matmul.allow_tf32` (off by
    default).
  * The fused kernels: K1 `ops/ds_block.fused_ds_block` for stride-1 DS
    blocks (QUANT_FUSED_DS), K3 `ops/mask_fused.fused_mask_branch` for the
    whole mask branch (QUANT_FUSED_MASK, the counterpart of the JAX
    package's `detect_outputs(use_pallas=True)`). The chained mask branch
    crops through K2 `ops/roi_crop.crop_rois`.

One deliberate difference: the JAX package's `_mask_layers` reads the
deconv kernel unflipped, `W[di, dj]`, while flax's ConvTranspose computes
`y[2i+di, 2j+dj] = Σ x[i, j]·W[1-di, 1-dj]`. The port flips it, so its
int8 masks follow the network; a JAX graph built from a tree whose deconv
kernel was flipped beforehand has the same layers as the port's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from . import pipelines
from .ops.ds_block import fused_ds_block, pack_ds_pair
from .ops.int8 import int_mm, quantize
from .ops.mask_fused import fused_mask_branch, pack_mask_weights, weights_to
from .ops.roi_align import crop_and_resize
from .ops.roi_crop import crop_rois

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item {})"

# ---------------------------------------------------------------------------
# BN folding + layer graph
# ---------------------------------------------------------------------------


def fold_conv_bn(kernel, bn_params, bn_stats, conv_bias=None, eps: float = 1e-3):
    """Fold an inference-mode BatchNorm into the preceding conv:
    y = conv(x)·f + (b - mean)·f + beta,  f = gamma / sqrt(var + eps)."""
    gamma = np.asarray(bn_params["scale"], np.float32)
    beta = np.asarray(bn_params["bias"], np.float32)
    mean = np.asarray(bn_stats["mean"], np.float32)
    var = np.asarray(bn_stats["var"], np.float32)
    f = gamma / np.sqrt(var + eps)
    k = np.asarray(kernel, np.float32) * f  # broadcast over trailing O axis
    b = np.zeros_like(mean) if conv_bias is None else np.asarray(conv_bias, np.float32)
    return k, (b - mean) * f + beta


@dataclass
class Layer:
    """One conv layer of the folded inference graph."""

    name: str
    kind: str          # 'conv' | 'dw' | 'out_d2s'
    kernel: Any        # f32 [kh, kw, I(/g), O]
    bias: Any          # f32 [O]
    strides: tuple = (1, 1)
    act: str = "relu6"  # 'relu6' | 'relu' | 'linear' | 'sigmoid'
    groups: int = 1
    quantize: bool = True
    # filled by quantize_weights():
    w_q: Any = None       # int8 kernel
    w_scale: Any = None   # f32 [O]
    a_scale: Any = 0.0    # input activation scale, a Python float
    act_folded: bool = False
    bias_corr: Any = None
    # device copies of the arrays above, keyed by (field, device)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)


def _tensor(layer: Layer, name: str, device, dtype=None):
    """layer.<name> as a tensor on `device`, cached while the array stays."""
    arr = getattr(layer, name)
    key = (name, str(device), dtype)
    hit = layer._dev.get(key)
    if hit is None or hit[0] is not arr:
        t = torch.as_tensor(np.asarray(arr), device=device)
        hit = (arr, t if dtype is None else t.to(dtype))
        layer._dev[key] = hit
    return hit[1]


def _scale_ok(s) -> bool:
    """A usable activation scale (a positive scalar)?"""
    if isinstance(s, np.ndarray):
        return bool(s.size) and bool(np.all(s > 0))
    return bool(s and s > 0.0)


def _ds_block(params, stats, name, strides, dw_int8: bool = False):
    """DepthwiseSeparable block → [dw layer, pw layer (int8)]."""
    p, s = params[name], stats[name]
    dwk, dwb = fold_conv_bn(p["conv_dw"]["kernel"], p["conv_dw_bn"], s["conv_dw_bn"])
    pwk, pwb = fold_conv_bn(p["conv_pw"]["kernel"], p["conv_pw_bn"], s["conv_pw_bn"])
    groups = int(dwk.shape[-1])   # depthwise kernel [kh, kw, 1, C]
    return [
        Layer(f"{name}/dw", "dw", dwk, dwb, strides, "relu6",
              groups=groups, quantize=dw_int8),
        Layer(f"{name}/pw", "conv", pwk, pwb, (1, 1), "relu6"),
    ]


def _auto_at_320(config, name: str) -> bool:
    """A QUANT_* switch whose None means: on for inputs of 320² and up."""
    v = getattr(config, name, None)
    return bool(int(config.IMAGE_SHAPE[0]) >= 320 if v is None else v)


def build_layer_graph(variables, config):
    """The folded inference layer graph of a flax-layout f32 variable tree:
    {'trunk' (stem + backbone), 'neck', 'yolo', 'mask': [Layer]}."""
    if config.BACKBONE != "mobilenet":
        raise NotImplementedError(
            f"int8 BACKBONE={config.BACKBONE!r} (hybrid mode) "
            + _NOT_PORTED.format(9))
    if tuple(getattr(config, "QUANT_MASK_F32_LAYERS", ()) or ()):
        raise NotImplementedError("QUANT_MASK_F32_LAYERS " + _NOT_PORTED.format(10))
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    dw_int8 = _auto_at_320(config, "QUANT_DW_INT8")
    stem_bf16 = _auto_at_320(config, "QUANT_STEM_BF16")

    bb_p, bb_s = params["backbone"], stats["backbone"]
    k, b = fold_conv_bn(bb_p["conv1"]["conv"]["kernel"], bb_p["conv1"]["bn"],
                        bb_s["conv1"]["bn"])
    trunk = [Layer("conv1", "conv", k, b, (2, 2), "relu6", quantize=not stem_bf16)]
    bb_strides = {"block2": (2, 2), "block4": (2, 2)}
    for i in range(1, 7):
        name = f"block{i}"
        trunk += _ds_block(bb_p, bb_s, name, bb_strides.get(name, (1, 1)), dw_int8)

    neck = [Layer("feature_map", "conv",
                  np.asarray(params["feature_map"]["kernel"], np.float32),
                  np.asarray(params["feature_map"]["bias"], np.float32),
                  (1, 1), "linear")]

    y_p, y_s = params["yolo"], stats["yolo"]
    yolo = []
    y_strides = {"block7": (2, 2), "block13": (2, 2)}
    for i in range(7, 15):
        name = f"block{i}"
        yolo += _ds_block(y_p, y_s, name, y_strides.get(name, (1, 1)), dw_int8)
    yolo.append(Layer("conv_23", "conv",
                      np.asarray(y_p["conv_23"]["kernel"], np.float32),
                      np.asarray(y_p["conv_23"]["bias"], np.float32),
                      (1, 1), "linear"))
    return {"trunk": trunk, "neck": neck, "yolo": yolo,
            "mask": _mask_layers(params["mask"], stats["mask"])}


def _mask_layers(m_p, m_s):
    """The folded mask-head chain. The 2×2/s2 deconv becomes a 1×1 conv to
    4·O channels in the (di, dj, o) block layout:
    y[2i+di, 2j+dj, o] = Σ_c x[i, j, c]·W[1-di, 1-dj, c, o] (flax's
    ConvTranspose), so the kernel is flipped before the reshape. The class
    conv after it is expanded block-diagonally to read that layout, and
    depth-to-space runs on its small per-class output."""
    mask = []
    for i in range(1, 5):
        k, b = fold_conv_bn(m_p[f"mask_conv{i}"]["kernel"],
                            m_p[f"mask_bn{i}"], m_s[f"mask_bn{i}"],
                            conv_bias=m_p[f"mask_conv{i}"].get("bias"))
        mask.append(Layer(f"mask_conv{i}", "conv", k, b, (1, 1), "relu"))
    dk = np.asarray(m_p["mask_deconv"]["kernel"], np.float32)[::-1, ::-1]  # [2, 2, C, O]
    kh, kw, ci, co = dk.shape
    dk_1x1 = np.ascontiguousarray(dk.transpose(2, 0, 1, 3)).reshape(1, 1, ci, kh * kw * co)
    mask.append(Layer("mask_deconv", "conv", dk_1x1,
                      np.tile(np.asarray(m_p["mask_deconv"]["bias"], np.float32), kh * kw),
                      (1, 1), "relu"))
    ok = np.asarray(m_p["mask_out"]["kernel"], np.float32)  # [1, 1, O, C]
    nc = ok.shape[-1]
    ok_block = np.zeros((1, 1, kh * kw * co, kh * kw * nc), np.float32)
    for blk in range(kh * kw):
        ok_block[0, 0, blk * co:(blk + 1) * co, blk * nc:(blk + 1) * nc] = ok[0, 0]
    mask.append(Layer("mask_out", "out_d2s", ok_block,
                      np.tile(np.asarray(m_p["mask_out"]["bias"], np.float32), kh * kw),
                      (1, 1), "sigmoid", quantize=False))
    return mask


# ---------------------------------------------------------------------------
# Forward execution (f32 reference / int8 quantized), NHWC
# ---------------------------------------------------------------------------

_ACTS = {
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "relu": torch.relu,
    "linear": lambda x: x,
    "sigmoid": torch.sigmoid,
}


def _same(n: int, k: int, s: int):
    """flax SAME along one axis: (pad before, pad after, output size)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2, out


def _windows(x, kh, kw, strides):
    """The kh·kw shifted, strided views of SAME-padded NHWC `x`, tap order
    (di, dj) — the row order of an HWIO kernel reshaped to [kh·kw·I, O]."""
    (t, bo, ho), (l, r, wo) = _same(x.shape[1], kh, strides[0]), _same(x.shape[2], kw, strides[1])
    xp = F.pad(x, (0, 0, l, r, t, bo))
    sh, sw = strides
    return [xp[:, di:di + sh * (ho - 1) + 1:sh, dj:dj + sw * (wo - 1) + 1:sw, :]
            for di in range(kh) for dj in range(kw)]


def _conv(x, kernel, strides, groups, matmul):
    """SAME conv of NHWC `x` with an HWIO `kernel`: im2col + `matmul` for a
    dense conv, shifted multiply-adds for a depthwise one."""
    kh, kw, cig, o = kernel.shape
    taps = _windows(x, kh, kw, strides)
    b, ho, wo = taps[0].shape[:3]
    if groups == 1:
        cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
        return matmul(cols.reshape(-1, kh * kw * cig),
                      kernel.reshape(kh * kw * cig, o)).reshape(b, ho, wo, o)
    if cig != 1 or groups != o:
        raise NotImplementedError(f"grouped conv with groups={groups}")
    acc_dtype = torch.int32 if kernel.dtype == torch.int8 else kernel.dtype
    w = kernel.reshape(kh * kw, o).to(acc_dtype)
    acc = taps[0].to(acc_dtype) * w[0]
    for t in range(1, len(taps)):
        acc = acc + taps[t].to(acc_dtype) * w[t]
    return acc


def _conv_f32(x, kernel, strides, groups=1):
    return _conv(x, kernel, strides, groups, torch.matmul)


def _conv_int8(x_q, w_q, strides, groups=1):
    """int8 x int8 → exact int32 accumulators."""
    return _conv(x_q, w_q, strides, groups, int_mm)


def _depth_to_space2(y):
    """[B, H, W, 4·O] → [B, 2H, 2W, O] (block layout [dh, dw, o])."""
    b, h, w, c4 = y.shape
    o = c4 // 4
    return y.reshape(b, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, o)


def run_layer_f32(layer: Layer, x, collect=None):
    """f32 execution of one folded layer; with `collect`, also appends
    (name, absmax of the input) for calibration."""
    if collect is not None:
        collect.append((layer.name, x.abs().amax()))
    y = _conv_f32(x, _tensor(layer, "kernel", x.device, torch.float32),
                  layer.strides, layer.groups) + _tensor(layer, "bias", x.device, torch.float32)
    y = _ACTS[layer.act](y)
    return _depth_to_space2(y) if layer.kind == "out_d2s" else y


def run_layer_int8(layer: Layer, x, x_scale=None, out_scale=None):
    """Quantized execution of one layer.

    x: int8 at scale `x_scale`, or f32 (x_scale None). With `out_scale` the
    output is requantized to int8 at it. Returns (y, y_scale): int8 and its
    scale, or f32 and None."""
    dev = x.device
    if layer.quantize and layer.w_q is not None and _scale_ok(layer.a_scale):
        x_q = quantize(x, layer.a_scale) if x_scale is None else x
        s_in = 1.0 if layer.act_folded else (layer.a_scale if x_scale is None else x_scale)
        acc = _conv_int8(x_q, _tensor(layer, "w_q", dev), layer.strides, layer.groups)
        bias = _tensor(layer, "bias", dev, torch.float32)
        if layer.bias_corr is not None:
            bias = bias + _tensor(layer, "bias_corr", dev, torch.float32)
        scale = _tensor(layer, "w_scale", dev, torch.float32) * float(np.float32(s_in))
        y = acc.float() * scale + bias
    else:
        # bf16 layer: bf16 operands, f32 accumulation and result
        if x_scale is not None:
            x = x.float() * float(np.float32(x_scale))
        xb = x.to(torch.bfloat16).float()
        k = _tensor(layer, "kernel", dev, torch.bfloat16).float()
        y = _conv_f32(xb, k, layer.strides, layer.groups) + _tensor(layer, "bias", dev,
                                                                    torch.float32)
    y = _ACTS[layer.act](y)
    if layer.kind == "out_d2s":
        y = _depth_to_space2(y)
    if out_scale is not None:
        return quantize(y, out_scale), out_scale
    return y, None


def _fusable_ds_pair(layer, nxt, x_scale):
    """Can (layer, nxt) run as one fused DS block (K1)? Needs an int8 input
    already at the dw scale, a stride-1 int8 depthwise, an int8 pointwise
    with a float input scale, and relu6 on both."""
    return (layer.kind == "dw" and layer.strides == (1, 1)
            and layer.quantize and layer.w_q is not None
            and layer.act == "relu6" and x_scale is not None
            and not isinstance(x_scale, np.ndarray)
            and nxt is not None and nxt.kind == "conv"
            and nxt.w_q is not None and isinstance(nxt.a_scale, float)
            and nxt.a_scale > 0.0 and nxt.act == "relu6")


def _packed_ds_pair(layer, nxt, scale, device):
    """pack_ds_pair's operands on `device`, cached on the dw layer."""
    key = ("ds_pack", str(device))
    hit = layer._dev.get(key)
    if (hit is None or hit[0] != scale or hit[1] is not layer.w_q
            or hit[2] is not nxt.w_q):
        arrays = pack_ds_pair(layer, nxt, scale)
        hit = (scale, layer.w_q, nxt.w_q,
               [torch.as_tensor(a, device=device) for a in arrays])
        layer._dev[key] = hit
    return hit[3]


def run_layers(layers, x, quant: bool, collect=None, fused_ds: bool = False,
               x_scale=None, out_scale=None):
    """Run a layer chain. x_scale: scale of an already-int8 `x`; out_scale:
    requantize the final output to int8 at it."""
    if not quant:
        assert x_scale is None and out_scale is None
        for layer in layers:
            x = run_layer_f32(layer, x, collect)
        return x
    scale = x_scale
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if fused_ds and _fusable_ds_pair(layer, nxt, scale):
            kdw, dwsb, wpw, pwsb = _packed_ds_pair(layer, nxt, scale, x.device)
            nxt2 = layers[i + 2] if i + 2 < len(layers) else None
            ds_out = (nxt2.a_scale if nxt2 is not None and isinstance(nxt2.a_scale, float)
                      and nxt2.a_scale > 0.0 else 0.0)
            x = fused_ds_block(x, kdw, dwsb, wpw, pwsb, a_pw=float(nxt.a_scale),
                               s_out=float(ds_out))
            scale = ds_out if ds_out else None
            i += 2
            continue
        # inter-layer tensors stay int8 whenever the next layer has a scale
        nxt_scale = nxt.a_scale if nxt is not None and _scale_ok(nxt.a_scale) else None
        x, scale = run_layer_int8(layer, x, scale, nxt_scale)
        i += 1
    if out_scale is not None:
        if scale is None:
            return quantize(x, out_scale)
        assert np.array_equal(np.asarray(scale), np.asarray(out_scale)), \
            "run_layers ended int8 at a scale != out_scale"
        return x
    assert scale is None  # segments end in an f32 (linear/sigmoid) layer
    return x


def _trunk_outputs(graph, images, quant: bool, collect=None, fused_ds: bool = False):
    """(raw yolo output, fmap). With int8 on both consumers at one scale,
    the trunk hands C4 over in int8 once (the JAX package's C4 hand-off)."""
    shared = None
    if quant and collect is None:
        na, ya = graph["neck"][0], graph["yolo"][0]
        if (na.quantize and na.w_q is not None and ya.quantize and ya.w_q is not None
                and _scale_ok(na.a_scale) and _scale_ok(ya.a_scale)
                and np.array_equal(np.asarray(na.a_scale), np.asarray(ya.a_scale))
                and na.act_folded == ya.act_folded):
            shared = na.a_scale
    c4 = run_layers(graph["trunk"], images, quant, collect, fused_ds=fused_ds,
                    out_scale=shared)
    fmap = run_layers(graph["neck"], c4, quant, collect, x_scale=shared)
    raw = run_layers(graph["yolo"], c4, quant, collect, fused_ds=fused_ds, x_scale=shared)
    return raw, fmap


def _mask_outputs(graph, rois, fmap, pool_size: int, num_classes: int, quant: bool,
                  collect=None):
    """[B, R, 2p, 2p, num_classes] sigmoid masks from one feature map. The
    int8 path crops the bf16 fmap through K2; calibration crops in f32."""
    if isinstance(fmap, (tuple, list)):
        raise NotImplementedError("multi-level (FPN) ROIAlign " + _NOT_PORTED.format(9))
    b, r = rois.shape[:2]
    if quant and collect is None:
        x = crop_rois(fmap.to(torch.bfloat16).contiguous(), rois.float().contiguous(),
                      pool_size)
    else:
        x = crop_and_resize(fmap.float(), rois.float(), (pool_size, pool_size))
    x = x.float().reshape(b * r, pool_size, pool_size, x.shape[-1])
    x = run_layers(graph["mask"], x, quant, collect)
    side = 2 * pool_size
    return x.reshape(b, r, side, side, num_classes)


# ---------------------------------------------------------------------------
# Calibration + weight quantization
# ---------------------------------------------------------------------------

_CALIB_ROIS = np.asarray([[0.0, 0.0, 1.0, 1.0], [0.1, 0.1, 0.6, 0.6],
                          [0.4, 0.4, 0.9, 0.9], [0.25, 0.25, 0.75, 0.75]], np.float32)


@torch.inference_mode()
def calibrate(graph, config, images, rois=None):
    """One f32 forward over calibration images (a float tensor [N, H, W, 3]
    in [0, 1]); sets each layer's a_scale to absmax / 127 as a Python float.
    rois: [N, R, 4] normalized boxes for the mask branch (default: four
    spread boxes)."""
    if bool(getattr(config, "QUANT_PER_CHANNEL_ACT", False)):
        raise NotImplementedError("QUANT_PER_CHANNEL_ACT " + _NOT_PORTED.format(10))
    if float(getattr(config, "QUANT_CALIB_PCT", 100.0) or 100.0) < 100.0:
        raise NotImplementedError("QUANT_CALIB_PCT < 100 " + _NOT_PORTED.format(10))
    if rois is None:
        rois = np.tile(_CALIB_ROIS[None], (images.shape[0], 1, 1))
    rois = torch.as_tensor(rois, device=images.device)
    collect = []
    _, fmap = _trunk_outputs(graph, images, quant=False, collect=collect)
    _mask_outputs(graph, rois, fmap, config.MASK_POOL_SIZE, config.NUM_CLASSES,
                  quant=False, collect=collect)
    absmax = {name: float(v.item()) for name, v in collect}
    for part in graph.values():
        for layer in part or ():
            if layer.name in absmax:
                layer.a_scale = absmax[layer.name] / 127.0 or 1.0
    return graph


def quantize_weights(graph):
    """Symmetric per-output-channel int8 weights for quantizable layers."""
    for part in graph.values():
        for layer in part or ():
            if layer.quantize:
                _quantize_layer_kernel(layer, np.asarray(layer.kernel, np.float32))
    return graph


def _quantize_layer_kernel(layer, k):
    """Set layer.w_q / w_scale from the f32 kernel `k` (HWIO)."""
    absmax = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    layer.w_q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    layer.w_scale = scale


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class QuantizedDetector:
    """int8 detect pipeline with the outputs of pipelines.detect_outputs
    (decode, NMS, top-K and paste stay f32)."""

    def __init__(self, graph, config):
        self.graph = graph
        self.config = config
        self._mask_weights = {}   # device → K3's packed weights

    @classmethod
    def from_variables(cls, variables, config, calib_images, device="cuda"):
        """variables: a flax-layout f32 tree; calib_images: [N, H, W, 3]
        float in [0, 1] (numpy or tensor), calibrated on `device` (the card
        unless the caller asks for the CPU)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        if bool(getattr(config, "QUANT_BIAS_CORRECT", False)):
            raise NotImplementedError("QUANT_BIAS_CORRECT " + _NOT_PORTED.format(10))
        graph = build_layer_graph(variables, config)
        images = torch.as_tensor(np.asarray(calib_images, np.float32)
                                 if not torch.is_tensor(calib_images) else calib_images,
                                 device=device).float()
        graph = calibrate(graph, config, images)
        return cls(quantize_weights(graph), config)

    def finetune(self, *args, **kwargs):
        raise NotImplementedError("quantization-aware finetune " + _NOT_PORTED.format(10))

    def infer_yolo_fn(self, fused_ds: bool | None = None):
        """images → infer_yolo outputs on the int8 trunk (fused_ds None:
        QUANT_FUSED_DS runs the stride-1 DS blocks as K1): the
        detection-only counterpart of detect_fn. The grid comes back f32;
        decode and the per-class NMS stay f32."""
        config = self.config

        def infer_yolo(images):
            return pipelines.infer_yolo_from_callables(
                lambda x: self.trunk(x, fused_ds=fused_ds), images, config)

        return infer_yolo

    @torch.inference_mode()
    def infer_yolo_outputs(self, images, fused_ds: bool | None = None):
        """Same contract as pipelines.infer_yolo_outputs, int8 trunk."""
        return self.infer_yolo_fn(fused_ds)(images)

    def trunk(self, images, quant: bool = True, fused_ds: bool | None = None):
        """images [B, H, W, 3] float in [0, 1] → (grid [B, gh, gw, nb, 5+C]
        f32, fmap [B, h, w, C] f32)."""
        if fused_ds is None:
            fused_ds = bool(getattr(self.config, "QUANT_FUSED_DS", False))
        raw, fmap = _trunk_outputs(self.graph, images, quant, fused_ds=fused_ds)
        b, gh, gw = raw.shape[:3]
        nb = self.config.N_BOX
        return raw.reshape(b, gh, gw, nb, raw.shape[-1] // nb).float(), fmap

    def mask_branch(self, rois, fmap, quant: bool = True):
        """→ [B, R, 2p, 2p, NUM_CLASSES] sigmoid masks (chained layers)."""
        return _mask_outputs(self.graph, rois, fmap, self.config.MASK_POOL_SIZE,
                             self.config.NUM_CLASSES, quant)

    def fused_mask(self, rois, fmap, classes):
        """K3: each ROI's class mask [B, R, 2p, 2p] from one kernel call."""
        key = str(fmap.device)
        if key not in self._mask_weights:
            self._mask_weights[key] = weights_to(
                pack_mask_weights(self.graph, self.config.NUM_CLASSES), fmap.device)
        return fused_mask_branch(fmap, rois, classes, self._mask_weights[key],
                                 pool=self.config.MASK_POOL_SIZE,
                                 num_classes=self.config.NUM_CLASSES)

    def detect_fn(self, fused_mask: bool = False, fused_ds: bool | None = None):
        """images → detect outputs. fused_mask runs the mask branch as K3
        (the JAX package's use_pallas); fused_ds (None: QUANT_FUSED_DS) runs
        the stride-1 DS blocks as K1."""
        config = self.config

        def detect(images):
            return pipelines.detect_from_callables(
                lambda x: self.trunk(x, fused_ds=fused_ds), self.mask_branch, images,
                config, fused_mask=self.fused_mask if fused_mask else None)

        return detect

    @torch.inference_mode()
    def detect_outputs(self, images, fused_mask: bool | None = None,
                       fused_ds: bool | None = None, mesh=None):
        """Same contract as pipelines.detect_outputs, int8 conv stack.
        fused_mask None reads QUANT_FUSED_MASK."""
        if mesh is not None:
            raise NotImplementedError("int8 detect over a mesh " + _NOT_PORTED.format(11))
        if fused_mask is None:
            fused_mask = bool(getattr(self.config, "QUANT_FUSED_MASK", False))
        return self.detect_fn(fused_mask, fused_ds)(images)
