"""Post-training int8 detect path — port of `mask_yolo_tpu/quant.py`.

Scheme (as in the JAX package):
  * BatchNorm is folded into the preceding conv's kernel and bias.
  * Weights: symmetric per-output-channel int8, scale = absmax / 127.
  * Activations: symmetric per-tensor int8 with static scales from one
    calibration pass (absmax of every layer's input over sample images, or
    a percentile of it with QUANT_CALIB_PCT). QUANT_PER_CHANNEL_ACT keeps
    the per-channel absmax instead and folds the vector, split
    SmoothQuant-style with the weights, into the int8 kernel.
  * Accumulation in int32, dequantized as acc·(w_scale·s_in) + bias in f32,
    activation, then requantized at the next layer's input scale, so the
    tensors between layers stay int8.
  * The mask deconv runs as a 1×1 conv to 4× channels plus depth-to-space;
    the class conv after it stays bf16 and consumes the (di, dj, o) layout
    block-diagonally.
  * The quality tools: `bias_correct` (QUANT_BIAS_CORRECT) measures each
    int8 layer's mean pre-activation error on the calibration batch and
    adds it back through `Layer.bias_corr`; `QuantizedDetector.finetune`
    distils the f32 graph into the int8 one with fake-quantized weights and
    activations (straight-through rounding); QUANT_MASK_F32_LAYERS keeps
    named mask layers in bf16.

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

Hybrid mode (a backbone other than MobileNet, i.e. "resnet50_fpn"): the
graph holds the mask layers only ('trunk', 'neck' and 'yolo' are None), the
float network's trunk (`float_trunk`, the model's own `MaskYoloNet` in eval
mode, bf16 in a bf16 config) gives the grid and the (P3, P4, P5) pyramid,
and the int8 mask head pools each ROI from its level: through K2 once a
level on the int8 path (`roi_crop.multilevel_crop_rois`), through the plain
`roi_align.multilevel_crop_and_resize` for calibration. K3 takes one map,
so QUANT_FUSED_MASK with a pyramid is refused when the detector is built
(the JAX package would hand the tuple to its kernel and fail inside it);
QUANT_FUSED_DS has no int8 trunk to act on and is ignored, as in JAX.

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
from .ops.int8 import int_mm, quantize, scale_tensor
from .ops.mask_fused import fused_mask_branch, pack_mask_weights, weights_to
from .ops.roi_align import crop_and_resize, multilevel_crop_and_resize
from .ops.roi_crop import crop_rois, multilevel_crop_rois

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
    # input activation scale: a Python float, or an f32 [C_in] vector when
    # QUANT_PER_CHANNEL_ACT calibrated per-channel scales
    a_scale: Any = 0.0
    # a vector a_scale is folded into w_q (per input channel), so the int8
    # dequantize factor is w_scale alone
    act_folded: bool = False
    # per-output-channel bias correction, added on the int8 path only
    bias_corr: Any = None
    # device copies of the arrays above, keyed by (field, device)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)


def _tensor(layer: Layer, name: str, device, dtype=None):
    """layer.<name> as a tensor on `device`, cached while the array stays."""
    arr = getattr(layer, name)
    key = (name, str(device), dtype)
    hit = layer._dev.get(key)
    if hit is None or hit[0] is not arr:
        with torch.inference_mode(False):   # a plain tensor: finetune's autograd saves it
            t = torch.as_tensor(np.asarray(arr), device=device)
            hit = (arr, t if dtype is None else t.to(dtype))
        layer._dev[key] = hit
    return hit[1]


def _scale_ok(s) -> bool:
    """A usable activation scale (a positive scalar, or an all-positive
    vector)?"""
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
    {'trunk' (stem + backbone), 'neck', 'yolo', 'mask': [Layer]}. Only the
    MobileNet trunk is quantized; for another backbone (hybrid mode)
    'trunk', 'neck' and 'yolo' are None and only the mask layers are built."""
    mask_f32 = getattr(config, "QUANT_MASK_F32_LAYERS", ()) or ()
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if config.BACKBONE != "mobilenet":
        return {"trunk": None, "neck": None, "yolo": None,
                "mask": _mask_layers(params["mask"], stats["mask"], f32_layers=mask_f32)}
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
            "mask": _mask_layers(params["mask"], stats["mask"], f32_layers=mask_f32)}


def _mask_layers(m_p, m_s, f32_layers=()):
    """The folded mask-head chain. The 2×2/s2 deconv becomes a 1×1 conv to
    4·O channels in the (di, dj, o) block layout:
    y[2i+di, 2j+dj, o] = Σ_c x[i, j, c]·W[1-di, 1-dj, c, o] (flax's
    ConvTranspose), so the kernel is flipped before the reshape. The class
    conv after it is expanded block-diagonally to read that layout, and
    depth-to-space runs on its small per-class output. f32_layers: names of
    mask layers ('mask_conv4', 'mask_deconv', ...) to run in bf16 instead of
    int8 (QUANT_MASK_F32_LAYERS, for localizing an int8 mask-AP cost)."""
    f32_layers = set(f32_layers or ())
    mask = []
    for i in range(1, 5):
        k, b = fold_conv_bn(m_p[f"mask_conv{i}"]["kernel"],
                            m_p[f"mask_bn{i}"], m_s[f"mask_bn{i}"],
                            conv_bias=m_p[f"mask_conv{i}"].get("bias"))
        mask.append(Layer(f"mask_conv{i}", "conv", k, b, (1, 1), "relu",
                          quantize=f"mask_conv{i}" not in f32_layers))
    dk = np.asarray(m_p["mask_deconv"]["kernel"], np.float32)[::-1, ::-1]  # [2, 2, C, O]
    kh, kw, ci, co = dk.shape
    dk_1x1 = np.ascontiguousarray(dk.transpose(2, 0, 1, 3)).reshape(1, 1, ci, kh * kw * co)
    mask.append(Layer("mask_deconv", "conv", dk_1x1,
                      np.tile(np.asarray(m_p["mask_deconv"]["bias"], np.float32), kh * kw),
                      (1, 1), "relu", quantize="mask_deconv" not in f32_layers))
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


def _percentile(values, pct: float):
    """The pct-th percentile of a tensor's values, interpolated linearly
    between the two nearest order statistics (numpy's and jnp.quantile's
    default). By sorting: torch.quantile refuses inputs above 16 M elements,
    and an early layer's input at 416² is larger."""
    flat = values.float().reshape(-1).sort().values
    pos = pct / 100.0 * (flat.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, flat.numel() - 1)
    frac = float(pos - lo)
    return flat[lo] * (1.0 - frac) + flat[hi] * frac


def run_layer_f32(layer: Layer, x, collect=None, calib_pct: float = 100.0):
    """f32 execution of one folded layer; with `collect`, also appends
    (name, range of the input) for calibration: the per-channel absmax
    vector (calibrate reduces it to a scalar unless QUANT_PER_CHANNEL_ACT
    keeps it), or with calib_pct < 100 that percentile of |x| over the whole
    tensor, a scalar."""
    if collect is not None:
        ax = x.abs()
        collect.append((layer.name, ax.amax(dim=tuple(range(ax.dim() - 1)))
                        if calib_pct >= 100.0 else _percentile(ax, calib_pct)))
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
            x = x.float() * (scale_tensor(x_scale, dev) if isinstance(x_scale, np.ndarray)
                             else float(np.float32(x_scale)))
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


def _k1_scale(s) -> bool:
    """A scale K1 packs: a positive Python float (per tensor), or an
    all-positive per-channel vector (QUANT_PER_CHANNEL_ACT)."""
    return (isinstance(s, float) and s > 0.0) or (isinstance(s, np.ndarray) and _scale_ok(s))


def _fusable_ds_pair(layer, nxt, x_scale):
    """Can (layer, nxt) run as one fused DS block (K1)? Needs an int8 input
    already at the dw scale, a stride-1 int8 depthwise, an int8 pointwise,
    both input scales floats or vectors, and relu6 on both."""
    return (layer.kind == "dw" and layer.strides == (1, 1)
            and layer.quantize and layer.w_q is not None
            and layer.act == "relu6" and _k1_scale(x_scale)
            and nxt is not None and nxt.kind == "conv"
            and nxt.w_q is not None and _k1_scale(nxt.a_scale) and nxt.act == "relu6")


def _packed_ds_pair(layer, nxt, scale, s_out, device):
    """pack_ds_pair's operands on `device`, cached on the dw layer while the
    arrays and scales it packed stay the layers' (compared by identity, so a
    vector scale is not compared element by element): bias_correct and
    finetune replace the int8 kernels or bias corrections, which drops the
    entry."""
    key = ("ds_pack", str(device))
    hit = layer._dev.get(key)
    src = (scale, s_out, nxt.a_scale, layer.w_q, nxt.w_q, layer.bias_corr, nxt.bias_corr)
    if hit is None or any(a is not b for a, b in zip(hit[0], src)):
        arrays = pack_ds_pair(layer, nxt, scale, s_out)
        hit = (src, [torch.as_tensor(a, device=device) for a in arrays])
        layer._dev[key] = hit
    return hit[1]


def run_layers(layers, x, quant: bool, collect=None, fused_ds: bool = False,
               calib_pct: float = 100.0, x_scale=None, out_scale=None):
    """Run a layer chain. x_scale: scale of an already-int8 `x`; out_scale:
    requantize the final output to int8 at it."""
    if not quant:
        assert x_scale is None and out_scale is None
        for layer in layers:
            x = run_layer_f32(layer, x, collect, calib_pct)
        return x
    scale = x_scale
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if fused_ds and _fusable_ds_pair(layer, nxt, scale):
            # the block ends int8 where the chained pair would: at the next
            # layer's scale, or at out_scale where the chain ends
            nxt2 = layers[i + 2] if i + 2 < len(layers) else None
            ds_out = out_scale if nxt2 is None else (
                nxt2.a_scale if _scale_ok(nxt2.a_scale) else None)
            kdw, dwsb, wpw, pwsb = _packed_ds_pair(layer, nxt, scale, ds_out, x.device)
            x = fused_ds_block(x, kdw, dwsb, wpw, pwsb, out_int8=ds_out is not None)
            scale = ds_out
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


def _trunk_outputs(graph, images, quant: bool, collect=None, fused_ds: bool = False,
                   calib_pct: float = 100.0):
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
                    calib_pct=calib_pct, out_scale=shared)
    fmap = run_layers(graph["neck"], c4, quant, collect, calib_pct=calib_pct, x_scale=shared)
    raw = run_layers(graph["yolo"], c4, quant, collect, fused_ds=fused_ds,
                     calib_pct=calib_pct, x_scale=shared)
    return raw, fmap


def _crop(fmap, rois, pool_size: int, image_hw, kernel: bool):
    """The mask branch's crop of one map, or of the FPN pyramid (each ROI
    from its level, each level cropped in its own dtype), through K2
    (`kernel`) or its plain version, as f32 [B·R, p, p, C]."""
    rois = rois.float().contiguous()
    if isinstance(fmap, (tuple, list)):
        if kernel:
            x = multilevel_crop_rois(fmap, rois, pool_size, image_hw)
        else:
            x = multilevel_crop_and_resize(tuple(fmap), rois, (pool_size, pool_size),
                                           image_hw=image_hw)
    elif kernel:
        x = crop_rois(fmap.contiguous(), rois, pool_size)
    else:
        x = crop_and_resize(fmap, rois, (pool_size, pool_size))
    return x.float().reshape(-1, pool_size, pool_size, x.shape[-1])


def _mask_outputs(graph, rois, fmap, pool_size: int, num_classes: int, quant: bool,
                  collect=None, calib_pct: float = 100.0, image_hw=(224, 224)):
    """[B, R, 2p, 2p, num_classes] sigmoid masks from one feature map or the
    FPN pyramid (image_hw: the input's pixel size, for the ROIs' levels).
    The int8 path crops the bf16 fmap through K2 (a pyramid in its own
    dtype, then rounded to bf16, as the JAX package does); calibration crops
    an f32 fmap, or the pyramid in its dtype, with the plain version."""
    b, r = rois.shape[:2]
    kernel = quant and collect is None
    if isinstance(fmap, (tuple, list)):
        x = _crop(fmap, rois, pool_size, image_hw, kernel)
        if kernel:
            x = x.to(torch.bfloat16).float()
    else:
        x = _crop(fmap.to(torch.bfloat16) if kernel else fmap.float(), rois, pool_size,
                  image_hw, kernel)
    x = run_layers(graph["mask"], x, quant, collect, calib_pct=calib_pct)
    side = 2 * pool_size
    return x.reshape(b, r, side, side, num_classes)


# ---------------------------------------------------------------------------
# Calibration + weight quantization
# ---------------------------------------------------------------------------

_CALIB_ROIS = np.asarray([[0.0, 0.0, 1.0, 1.0], [0.1, 0.1, 0.6, 0.6],
                          [0.4, 0.4, 0.9, 0.9], [0.25, 0.25, 0.75, 0.75]], np.float32)


def _default_rois(n: int):
    return np.tile(_CALIB_ROIS[None], (n, 1, 1))


def _hybrid(graph) -> bool:
    return graph["trunk"] is None


def _trunk_fmap(graph, images, float_trunk, collect=None, calib_pct: float = 100.0):
    """The mask branch's input for calibration and the quality tools: the
    f32 graph's fmap, or in hybrid mode the float trunk's pyramid."""
    if not _hybrid(graph):
        return _trunk_outputs(graph, images, quant=False, collect=collect,
                              calib_pct=calib_pct)[1]
    if float_trunk is None:
        raise ValueError("a hybrid-mode graph (no int8 trunk) needs float_trunk=")
    return float_trunk(images)[1]


@torch.inference_mode()
def calibrate(graph, config, images, rois=None, float_trunk=None):
    """One f32 forward over calibration images (a float tensor [N, H, W, 3]
    in [0, 1]); sets each layer's a_scale. rois: [N, R, 4] normalized boxes
    for the mask branch (default: four spread boxes). float_trunk: in hybrid
    mode, images → (grid, pyramid), the float network's trunk whose pyramid
    feeds the mask layers.

    Per tensor (the default): absmax / 127, or with QUANT_CALIB_PCT < 100
    that percentile of |x| / 127, as a Python float. With
    QUANT_PER_CHANNEL_ACT (absmax only) the per-channel absmax vector stays:
    a quantized layer takes the SmoothQuant split r_c = a_c^α / w_c^(1-α)
    (Xiao et al. 2022; α = QUANT_SMOOTH_ALPHA, default 0.5, w_c the kernel's
    absmax over input channel c) scaled so the largest a_c / r_c lands on
    127; folding the whole activation range into the kernel would only
    move the imbalance into the weight grid. A bf16 layer, whose scale only
    stores its input as int8, takes the exact a_c / 127. Dead channels
    (absmax 0) take the median live scale, so they cannot dominate the
    folded kernel's per-output-channel absmax. The split is computed in
    numpy, in the JAX package's dtypes."""
    pct = float(getattr(config, "QUANT_CALIB_PCT", 100.0) or 100.0)
    per_ch = bool(getattr(config, "QUANT_PER_CHANNEL_ACT", False)) and pct >= 100.0
    if rois is None:
        rois = _default_rois(images.shape[0])
    rois = torch.as_tensor(rois, device=images.device)
    collect = []
    fmap = _trunk_fmap(graph, images, float_trunk, collect, pct)
    _mask_outputs(graph, rois, fmap, config.MASK_POOL_SIZE, config.NUM_CLASSES,
                  quant=False, collect=collect, calib_pct=pct,
                  image_hw=tuple(config.IMAGE_SHAPE[:2]))
    stats = {name: np.asarray(v.cpu().numpy(), np.float32) for name, v in collect}
    alpha = float(getattr(config, "QUANT_SMOOTH_ALPHA", 0.5))
    for part in graph.values():
        for layer in part or ():
            if layer.name not in stats:
                continue
            v = stats[layer.name]
            if not (per_ch and v.ndim == 1):
                layer.a_scale = float(v.max()) / 127.0 or 1.0
                continue
            if layer.quantize:
                k = np.abs(np.asarray(layer.kernel, np.float32))
                ax = k.ndim - 1 if layer.kind == "dw" else k.ndim - 2
                w_c = np.moveaxis(k, ax, 0).reshape(k.shape[ax], -1).max(axis=1)
                a_c = np.maximum(v, 1e-12)
                w_c = np.maximum(w_c, 1e-12)
                r = a_c ** alpha / w_c ** (1.0 - alpha)
                s = r * (float(np.max(a_c / r)) / 127.0)
            else:
                s = v / 127.0
            pos = s[v > 0]
            fill = float(np.median(pos)) if pos.size else 1.0
            layer.a_scale = np.where(v > 0, s, fill).astype(np.float32)
    return graph


def quantize_weights(graph):
    """Symmetric per-output-channel int8 weights for quantizable layers. A
    vector a_scale folds into the kernel first: y = Σ_ci W[.., ci, co]·
    (x_q[.., ci]·s_ci) = Σ_ci (W·s_ci)[.., ci, co]·x_q[.., ci], so the int8
    product and its per-output-channel dequantize stay as they are and the
    input's factor becomes exactly 1."""
    for part in graph.values():
        for layer in part or ():
            if layer.quantize:
                _quantize_layer_kernel(layer, np.asarray(layer.kernel, np.float32))
    return graph


def _quantize_layer_kernel(layer, k):
    """Set layer.w_q / w_scale from the f32 kernel `k` (HWIO), folding a
    vector a_scale along the input-channel axis first: the trailing axis of
    a depthwise [kh, kw, 1, C], whose output channel c reads input channel
    c only."""
    if isinstance(layer.a_scale, np.ndarray):
        k = k * layer.a_scale.reshape((1, 1, 1, -1) if layer.kind == "dw" else (1, 1, -1, 1))
        layer.act_folded = True
    absmax = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    layer.w_q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    layer.w_scale = scale


def _int8_layer(layer) -> bool:
    """Does run_layer_int8 run this layer's product in int8?"""
    return layer.quantize and layer.w_q is not None and _scale_ok(layer.a_scale)


@torch.inference_mode()
def bias_correct(graph, config, images, rois=None, float_trunk=None):
    """Per-output-channel bias correction (Nagel et al. 2019, "Data-Free
    Quantization Through Weight Equalization and Bias Correction", §5), after
    quantize_weights. For every int8 layer the mean pre-activation error
    E[conv_f32(x) − deq(conv_int8(quant(x)))] over the calibration batch,
    with x from the exact f32 forward (each layer is corrected on its own,
    errors do not compound), lands in layer.bias_corr, which the int8 path
    adds and the f32 path ignores. images: float tensor [N, H, W, 3] in
    [0, 1]; rois and float_trunk as in calibrate."""
    if rois is None:
        rois = _default_rois(images.shape[0])
    rois = torch.as_tensor(rois, device=images.device).float()

    def correct_chain(layers, x):
        for layer in layers:
            if _int8_layer(layer):
                dev = x.device
                y_f = _conv_f32(x, _tensor(layer, "kernel", dev, torch.float32),
                                layer.strides, layer.groups)
                s_in = 1.0 if layer.act_folded else layer.a_scale
                y_q = _conv_int8(quantize(x, layer.a_scale), _tensor(layer, "w_q", dev),
                                 layer.strides, layer.groups).float() * (
                    _tensor(layer, "w_scale", dev, torch.float32) * float(np.float32(s_in)))
                layer.bias_corr = (y_f - y_q).mean(dim=(0, 1, 2)).cpu().numpy()
            x = run_layer_f32(layer, x)
        return x

    if _hybrid(graph):
        fmap = _trunk_fmap(graph, images, float_trunk)
    else:
        c4 = correct_chain(graph["trunk"], images)
        fmap = correct_chain(graph["neck"], c4).float()
        correct_chain(graph["yolo"], c4)
    correct_chain(graph["mask"], _crop(fmap, rois, config.MASK_POOL_SIZE,
                                       tuple(config.IMAGE_SHAPE[:2]), kernel=False))
    return graph


# ---------------------------------------------------------------------------
# Quantization-aware fine-tuning (distillation, no labels)
# ---------------------------------------------------------------------------


def _fq(v, s):
    """Quantize → dequantize at scale `s` (a float, a numpy vector over the
    last axis, or a tensor) with a straight-through gradient: autograd does
    not see the round and clip."""
    if isinstance(s, np.ndarray):
        s = scale_tensor(s, v.device)
    q = torch.clamp(torch.round(v / s), -127, 127) * s
    return v + (q - v).detach()


def _fq_kernel(k, layer):
    """The f32 kernel the int8 path realizes from `k`: fold a vector a_scale,
    fake-quantize at per-output-channel scales, unfold. The scales are
    recomputed from the current kernel (outside autograd), so absmax follows
    the weights as they drift."""
    fold = None
    if isinstance(layer.a_scale, np.ndarray):
        fold = scale_tensor(layer.a_scale, k.device).reshape(
            (1, 1, 1, -1) if layer.kind == "dw" else (1, 1, -1, 1))
        k = k * fold
    s = k.detach().abs().amax(dim=(0, 1, 2), keepdim=True).clamp_min(1e-12) / 127.0
    k = _fq(k, s)
    return k if fold is None else k / fold


def _run_layers_fq(layers, x, params):
    """f32 forward with fake-quantized weights and activations on the layers
    the int8 path quantizes: the differentiable simulation of
    run_layers(quant=True). params: {layer.name: {"kernel", "bias"}}
    trainable tensors (HWIO kernels) that override the layer's own."""
    for layer in layers:
        p = params.get(layer.name)
        k = p["kernel"] if p else _tensor(layer, "kernel", x.device, torch.float32)
        b = p["bias"] if p else _tensor(layer, "bias", x.device, torch.float32)
        if _int8_layer(layer):
            x = _fq(x, layer.a_scale)
            k = _fq_kernel(k, layer)
        x = _ACTS[layer.act](_conv_f32(x, k, layer.strides, layer.groups) + b)
        if layer.kind == "out_d2s":
            x = _depth_to_space2(x)
    return x


def _nmse(x, t):
    return ((x - t) ** 2).mean() / ((t ** 2).mean() + 1e-8)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class QuantizedDetector:
    """int8 detect pipeline with the outputs of pipelines.detect_outputs
    (decode, NMS, top-K and paste stay f32).

    In hybrid mode (a graph without an int8 trunk) `float_net`, the float
    `MaskYoloNet` of the same weights, runs the trunk (`pick_trunk`, the
    pyramid for the FPN network) in eval mode, and only the mask head runs
    int8. The detector holds the network itself, not a copy: a change to
    its weights reaches the trunk (MaskYOLO drops the detector on any)."""

    def __init__(self, graph, config, device=None, float_net=None):
        if _hybrid(graph):
            if float_net is None:
                raise ValueError(f"BACKBONE={config.BACKBONE!r} quantizes in hybrid mode: "
                                 f"pass net= so that the trunk runs in float")
            if getattr(config, "QUANT_FUSED_MASK", False):
                raise ValueError("QUANT_FUSED_MASK: the fused mask kernel (K3) takes one "
                                 "feature map, and a hybrid-mode detector gives the mask "
                                 "head the FPN pyramid; the int8 mask head runs as chained "
                                 "layers (set QUANT_FUSED_MASK = False)")
        self.graph = graph
        self.config = config
        self.device = None if device is None else torch.device(device)
        self.float_net = float_net if _hybrid(graph) else None
        self.finetune_result = None   # the last finetune's {"loss_initial", "loss_final"}
        self._mask_weights = {}   # device → (the arrays packed, K3's packed weights)

    @classmethod
    def from_variables(cls, variables, config, calib_images, device="cuda", net=None):
        """variables: a flax-layout f32 tree; calib_images: [N, H, W, 3]
        float in [0, 1] (numpy or tensor), calibrated on `device` (the card
        unless the caller asks for the CPU). net: the `MaskYoloNet` of these
        weights on `device`, required in hybrid mode (BACKBONE other than
        "mobilenet"), whose trunk then stays float."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        graph = build_layer_graph(variables, config)
        det = cls(graph, config, device=device, float_net=net)
        images = torch.as_tensor(np.asarray(calib_images, np.float32)
                                 if not torch.is_tensor(calib_images) else calib_images,
                                 device=device).float()
        graph = quantize_weights(calibrate(graph, config, images,
                                           float_trunk=det.float_trunk))
        if bool(getattr(config, "QUANT_BIAS_CORRECT", False)):
            graph = bias_correct(graph, config, images, float_trunk=det.float_trunk)
        return det

    def float_trunk(self, images):
        """Hybrid mode's trunk: images [B, H, W, 3] float in [0, 1] → (grid
        f32, pyramid or fmap) of the float network in eval mode."""
        self.float_net.eval()
        grid, fmap = self.float_net.pick_trunk()(pipelines.images_f32(images))
        return grid.float(), fmap

    def finetune(self, images, rois=None, steps: int = 200, lr: float = 1e-5, seed: int = 0):
        """Quantization-aware fine-tuning by distillation, without labels.

        Tunes the int8 layers' kernels and biases so that the int8 forward
        matches the f32 teacher's outputs (raw grid, feature map, mask
        probabilities) on `images` ([N, H, W, 3] float in [0, 1]), with the
        straight-through fake quantization inside the loss; the normalized
        MSE of the three, the mask term weighted by QUANT_QAT_MASK_WEIGHT.
        Adam at `lr` with optax's defaults (betas 0.9 / 0.999, eps 1e-8, no
        weight decay) on leaf tensors on the detector's device; the student's
        crop goes through ops/roi_crop.crop_rois, so on the card K2 runs
        forward and backward. The best point observed is kept, the last
        update included. `seed` is the JAX package's parameter; nothing
        random is drawn.

        The result goes only into the int8 graph: tuned kernels requantize
        into w_q / w_scale, tuned biases land in bias_corr; the f32 layers
        keep the exact weights. Returns {"loss_initial", "loss_final"}."""
        del seed
        graph, cfg = self.graph, self.config
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images))
        # on the detector's device (the images' own for one built without)
        images = images.to(self.device or images.device).float()
        dev = images.device
        if rois is None:
            rois = _default_rois(images.shape[0])
        rois = torch.as_tensor(rois, device=dev).float().contiguous()
        hybrid = _hybrid(graph)
        hw = tuple(cfg.IMAGE_SHAPE[:2])

        def crop(fmap):   # K2 (once a pyramid level), in f32 or the pyramid's dtype
            return _crop(fmap if hybrid else fmap.float(), rois, cfg.MASK_POOL_SIZE, hw,
                         kernel=True)

        with torch.no_grad():
            if hybrid:
                raw_t, fmap_t = None, self.float_trunk(images)[1]
            else:
                raw_t, fmap_t = _trunk_outputs(graph, images, quant=False)
            mask_t = run_layers(graph["mask"], crop(fmap_t), quant=False)

        tuned = [l for part in graph.values() for l in part or ()
                 if l.quantize and l.w_q is not None]
        if not tuned:
            self.finetune_result = {"loss_initial": 0.0, "loss_final": 0.0}
            return self.finetune_result
        params = {}
        for l in tuned:
            bias = np.asarray(l.bias, np.float32)
            if l.bias_corr is not None:
                bias = bias + l.bias_corr
            params[l.name] = {
                "kernel": torch.tensor(np.asarray(l.kernel, np.float32), device=dev,
                                       requires_grad=True),
                "bias": torch.tensor(bias, device=dev, requires_grad=True)}
        leaves = [t for p in params.values() for t in p.values()]
        mw = float(getattr(cfg, "QUANT_QAT_MASK_WEIGHT", 1.0) or 1.0)

        def loss_fn():
            if hybrid:   # the trunk stays float: the teacher's pyramid
                fmap, loss = fmap_t, 0.0
            else:
                c4 = _run_layers_fq(graph["trunk"], images, params)
                fmap = _run_layers_fq(graph["neck"], c4, params)
                raw = _run_layers_fq(graph["yolo"], c4, params)
                loss = _nmse(raw, raw_t) + _nmse(fmap, fmap_t)
            mask = _run_layers_fq(graph["mask"], crop(fmap), params)
            return loss + mw * _nmse(mask, mask_t)

        opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
        snapshot = lambda: [t.detach().clone() for t in leaves]   # noqa: E731
        loss0, best = None, (np.inf, None)
        for _ in range(int(steps)):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            value = float(loss.detach())   # the loss at the point before this update
            if loss0 is None:
                loss0 = value
            if value < best[0]:
                best = (value, snapshot())
            opt.step()
        with torch.no_grad():            # the last update's point is unscored so far
            final = float(loss_fn())
        if final < best[0]:
            best = (final, snapshot())
        loss, values = best
        if loss0 is None:
            loss0 = loss

        with torch.no_grad():
            for leaf, value in zip(leaves, values):
                leaf.copy_(value)
        for l in tuned:
            p = params[l.name]
            _quantize_layer_kernel(l, p["kernel"].detach().cpu().numpy())
            l.bias_corr = p["bias"].detach().cpu().numpy() - np.asarray(l.bias, np.float32)
        self.finetune_result = {"loss_initial": loss0, "loss_final": loss}
        return self.finetune_result

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
        f32, fmap [B, h, w, C] f32); in hybrid mode the float trunk's
        (grid, pyramid), whatever quant and fused_ds say."""
        if _hybrid(self.graph):
            return self.float_trunk(images)
        if fused_ds is None:
            fused_ds = bool(getattr(self.config, "QUANT_FUSED_DS", False))
        raw, fmap = _trunk_outputs(self.graph, images, quant, fused_ds=fused_ds)
        b, gh, gw = raw.shape[:3]
        nb = self.config.N_BOX
        return raw.reshape(b, gh, gw, nb, raw.shape[-1] // nb).float(), fmap

    def mask_branch(self, rois, fmap, quant: bool = True):
        """→ [B, R, 2p, 2p, NUM_CLASSES] sigmoid masks (chained layers), from
        one map or the pyramid."""
        return _mask_outputs(self.graph, rois, fmap, self.config.MASK_POOL_SIZE,
                             self.config.NUM_CLASSES, quant,
                             image_hw=tuple(self.config.IMAGE_SHAPE[:2]))

    def fused_mask(self, rois, fmap, classes):
        """K3: each ROI's class mask [B, R, 2p, 2p] from one kernel call. The
        packed weights are kept while the arrays they were packed from stay
        the mask layers' (bias_correct and finetune replace them)."""
        if isinstance(fmap, (tuple, list)):
            raise ValueError("the fused mask kernel (K3) takes one feature map, not the "
                             "FPN pyramid")
        key = str(fmap.device)
        src = [a for l in self.graph["mask"] for a in (l.w_q, l.w_scale, l.bias_corr, l.a_scale)]
        hit = self._mask_weights.get(key)
        if hit is None or any(a is not b for a, b in zip(hit[0], src)):
            hit = (src, weights_to(pack_mask_weights(self.graph, self.config.NUM_CLASSES),
                                   fmap.device))
            self._mask_weights[key] = hit
        return fused_mask_branch(fmap, rois, classes, hit[1],
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
        fused_mask None reads QUANT_FUSED_MASK.

        mesh: a parallel.mesh.Mesh; `images` is then this rank's local batch.
        The int8 weights are replicated and the pipeline treats each image on
        its own, so each rank detects its slice with no collective (the JAX
        package's shard_map branch)."""
        del mesh   # every rank runs its local batch as a single process does
        if fused_mask is None:
            fused_mask = bool(getattr(self.config, "QUANT_FUSED_MASK", False))
        return self.detect_fn(fused_mask, fused_ds)(images)
