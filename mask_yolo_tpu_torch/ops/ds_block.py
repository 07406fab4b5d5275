"""The fused int8 depthwise-separable block: a hand-written CUDA kernel on GPU
tensors.

`fused_ds_block` replaces the TPU kernel
`mask_yolo_tpu/ops/pallas_ds.py::fused_ds_block` (K1). On a CUDA tensor it
launches `csrc/fused_ds_block.cu` or raises; on a CPU tensor it runs the
plain version `fused_ds_block_reference`. The plain version is the kernel's
reference, never its fallback: no path leads from a CUDA tensor to it.

One stride-1 block, int8 in, int8 (or f32) out:
  1. 3×3 depthwise conv, nine int8 taps accumulated in int32, zero padding;
  2. ·dwsb[0] + dwsb[1], relu6, requantize to int8 by dwsb[2];
  3. [pixels, C] × [C, O] int8 GEMM accumulated in int32;
  4. ·pwsb[0] + pwsb[1], relu6, then int8 by pwsb[2], or f32.
Row 2 of each holds the requantize's inverse scale per channel: the
pointwise layer's input scale over C, the next layer's over O. A
per-channel graph (QUANT_PER_CHANNEL_ACT) gives vectors, a per-tensor one
its scalar repeated, so both run one kernel body. The arithmetic is the
chained int8 path's (quant.run_layer_int8 twice), bit for bit: requantize
as round_half_even(y · (f32(1) / f32(scale))), the inverse computed once on
the host when the pair is packed. The TPU kernel takes scalar scales only,
its inverse in f64 (`pallas_ds.py:45-47,122`); the port uses the chained
path's f32 form.

The block is the `torch.library` custom op `mask_yolo_tpu_torch::fused_ds_block`
(registered at import; the kernel builds at its first launch): a CUDA kernel
(the launch below), a CPU kernel (the plain version) and a fake whose dtype
follows the `out_int8` flag, and no device-generic implementation.
`torch.export` records the op (export.py), so an exported program launches
the kernel.

`fused_ds_block.launches` counts kernel launches, in the op's CUDA kernel
(CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .int8 import int_mm, inv_scale, quantize_inv


def _full_bias(layer):
    bias = np.asarray(layer.bias, np.float32)
    corr = getattr(layer, "bias_corr", None)
    return bias if corr is None else bias + np.asarray(corr, np.float32)


def _inverse_row(scale, n):
    """The requantize's f32 inverses of `scale` (a float, or an [n] vector)
    as a row of n."""
    return np.broadcast_to(np.asarray(inv_scale(scale), np.float32), (n,))


def pack_ds_pair(dw_layer, pw_layer, s_in, s_out=None):
    """quant.Layer pair → the kernel's operands (numpy):
    kdw [9, C] int8 taps in (di, dj) order, dwsb [3, C] f32 =
    (dw.w_scale · s_dw, dw.bias, 1 / pw.a_scale), wpw [O, C] int8
    (K-contiguous: the transpose of the JAX package's [C, O]), pwsb [3, O]
    f32 = (pw.w_scale · s_pw, pw.bias, 1 / s_out, or 0 for an f32 output).
    s_in: the int8 input's scale; s_out: the output's (None: f32). Either
    may be a float or a per-channel vector, as pw.a_scale may. Each layer's
    input factor follows quant.run_layer_int8: s_dw = s_in and s_pw =
    pw.a_scale, or 1 where the layer's vector scale is folded into its
    weights (act_folded). Each bias is bias + bias_corr where the layer has
    a correction, as run_layer_int8 adds it. The inverses are
    ops/int8.inv_scale's, the chained path's quantize."""
    assert dw_layer.kind == "dw" and dw_layer.strides == (1, 1)
    assert dw_layer.quantize and dw_layer.w_q is not None
    assert pw_layer.kind == "conv" and pw_layer.w_q is not None
    assert dw_layer.act == "relu6" and pw_layer.act == "relu6"
    c = dw_layer.w_q.shape[-1]
    o = pw_layer.w_q.shape[-1]
    s_dw = 1.0 if dw_layer.act_folded else s_in
    s_pw = 1.0 if pw_layer.act_folded else pw_layer.a_scale
    kdw = np.ascontiguousarray(np.asarray(dw_layer.w_q).reshape(9, c))
    dwsb = np.stack([np.asarray(dw_layer.w_scale, np.float32) * np.float32(s_dw),
                     _full_bias(dw_layer), _inverse_row(pw_layer.a_scale, c)])
    wpw = np.ascontiguousarray(np.asarray(pw_layer.w_q).reshape(c, o).T)
    pwsb = np.stack([np.asarray(pw_layer.w_scale, np.float32) * np.float32(s_pw),
                     _full_bias(pw_layer),
                     np.zeros(o, np.float32) if s_out is None else _inverse_row(s_out, o)])
    return kdw, dwsb, wpw, pwsb


def fused_ds_block_reference(x_q, kdw, dwsb, wpw, pwsb, out_int8: bool):
    """Plain PyTorch version of the kernel, on any device."""
    b, h, w, c = x_q.shape
    xp = F.pad(x_q, (0, 0, 1, 1, 1, 1)).to(torch.int32)
    taps = kdw.to(torch.int32)
    acc = xp[:, 0:h, 0:w] * taps[0]
    for t in range(1, 9):
        di, dj = divmod(t, 3)
        acc = acc + xp[:, di:di + h, dj:dj + w] * taps[t]
    y = torch.clamp(acc.float() * dwsb[0] + dwsb[1], 0.0, 6.0)
    q = quantize_inv(y, dwsb[2])
    acc2 = int_mm(q.reshape(-1, c), wpw.t()).reshape(b, h, w, -1)
    y2 = torch.clamp(acc2.float() * pwsb[0] + pwsb[1], 0.0, 6.0)
    return quantize_inv(y2, pwsb[2]) if out_int8 else y2


def _kernel():
    fn = _build.load("fused_ds_block").fused_ds_block
    # x_q, kdw, dwsb, wpw, pwsb, out, B, H, W, C, O, out_int8, stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_ds_block(x_q, kdw, dwsb, wpw, pwsb, out_int8: bool):
    """Fused stride-1 depthwise-separable block (operands of pack_ds_pair,
    as tensors on one device).

    x_q: [B, H, W, C] int8 at the depthwise layer's input scale (folded into
    dwsb[0]). out_int8: requantize the output by pwsb[2]'s inverses (packed
    with s_out), else return f32. Returns [B, H, W, O] int8 or f32."""
    if x_q.dim() != 4 or x_q.dtype != torch.int8:
        raise TypeError(f"x_q must be int8 [B, H, W, C], got {x_q.dtype} {tuple(x_q.shape)}")
    b, h, w, c = x_q.shape
    o = wpw.shape[0] if wpw.dim() == 2 else -1
    expect = {"kdw": (kdw, (9, c), torch.int8), "dwsb": (dwsb, (3, c), torch.float32),
              "wpw": (wpw, (o, c), torch.int8), "pwsb": (pwsb, (3, o), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x_q.device:
            raise ValueError(f"{name} on {t.device} but x_q on {x_q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the packed layout)")
    if not isinstance(out_int8, bool):
        raise TypeError(f"out_int8 must be a bool, got {type(out_int8).__name__}")
    if x_q.device.type == "cuda":
        if c % 32 or o % 16:
            raise ValueError(f"the kernel needs C % 32 == 0 and O % 16 == 0, got C={c}, O={o}")
        if not x_q.is_contiguous():
            raise ValueError("fused_ds_block needs a contiguous x_q")
    elif x_q.device.type != "cpu":
        raise ValueError(f"fused_ds_block runs on cpu or cuda tensors, got {x_q.device}")
    return torch.ops.mask_yolo_tpu_torch.fused_ds_block(x_q, kdw, dwsb, wpw, pwsb, out_int8)


def _block_cuda(x_q, kdw, dwsb, wpw, pwsb, out_int8):
    b, h, w, c = x_q.shape
    o = wpw.shape[0]
    out = torch.empty((b, h, w, o), dtype=torch.int8 if out_int8 else torch.float32,
                      device=x_q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x_q.data_ptr(), kdw.data_ptr(), dwsb.data_ptr(), wpw.data_ptr(),
                       pwsb.data_ptr(), out.data_ptr(), b, h, w, c, o, int(out_int8), stream)
    if rc != 0:
        raise RuntimeError(f"fused_ds_block kernel launch failed with CUDA error {rc}")
    fused_ds_block.launches += 1
    return out


def _block_cpu(x_q, kdw, dwsb, wpw, pwsb, out_int8):
    return fused_ds_block_reference(x_q, kdw, dwsb, wpw, pwsb, out_int8)


def _block_fake(x_q, kdw, dwsb, wpw, pwsb, out_int8):
    return x_q.new_empty((*x_q.shape[:3], wpw.shape[0]),
                         dtype=torch.int8 if out_int8 else torch.float32)


fused_ds_block.launches = 0
_LIB = torch.library.Library("mask_yolo_tpu_torch", "FRAGMENT")
_LIB.define("fused_ds_block(Tensor x_q, Tensor kdw, Tensor dwsb, Tensor wpw, Tensor pwsb, "
            "bool out_int8) -> Tensor")
_LIB.impl("fused_ds_block", _block_cpu, "CPU")
_LIB.impl("fused_ds_block", _block_cuda, "CUDA")
torch.library.register_fake("mask_yolo_tpu_torch::fused_ds_block", _block_fake, lib=_LIB)
