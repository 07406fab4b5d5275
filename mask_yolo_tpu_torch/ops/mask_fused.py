"""The fused int8 mask branch: a hand-written CUDA kernel on GPU tensors.

`fused_mask_branch` replaces the TPU kernel
`mask_yolo_tpu/ops/pallas_mask.py::fused_mask_branch` (K3). On a CUDA
tensor it launches `csrc/fused_mask_branch.cu` or raises; on a CPU tensor
it runs the plain version `fused_mask_branch_reference`, which follows the
TPU kernel's body (`_mask_kernel`) step by step:

  1. bilinear crop of each ROI from the bf16 fmap, both contractions
     rounded to bf16 (ops/roi_align.crop_and_resize in bf16);
  2. int8 at asc[0];
  3. four 3×3 convs over each ROI's zero-padded P×P tile: int8 GEMM with
     int32 accumulation, ·(wsc[l]·asc[l]) + bias[l], relu, int8 at asc[l+1];
  4. the deconv as a 1×1 int8 conv to 4·co channels, ·(wsc[4]·asc[4]) +
     bias[4], relu, int8 at asc[5];
  5. the class conv in bf16: bf16(y_q)·bf16(asc[5]) against bf16 wo with
     f32 accumulation, + bias[5], sigmoid;
  6. each ROI's class, per (di, dj) block; stored as bf16, returned as f32
     after depth-to-space → [B, K, 2P, 2P].

The weights arrive packed for the kernel (`pack_mask_weights`: K-contiguous,
128-byte-swizzled rows); the plain version reads the same packed dict and
unpacks it (`unpack_mask_weights`) on every call.

The kernel's GEMM tiles are 128 input channels by 256 output channels, so
`pack_mask_weights` pads the graph's widths with zero channels up to them
(Cf to a multiple of `CIN_TILE`, co to `CO_TILE`), and the wrapper hands the
kernel an fmap padded with zero channels where Cf is not a multiple
already. A zero int8 channel adds nothing to an int32 product, a padded
output channel has zero weights, scale and bias and so stays exactly 0
through relu and requantize, and its class-conv weight is 0: the result
equals the true width's. At the full widths (Cf = 256, co = 256) nothing is
padded or copied.

`fused_mask_branch.launches` counts kernel calls (one per call; CPU calls
do not count).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .int8 import int_mm, quantize
from .roi_align import crop_and_resize

_LAYER_NAMES = ["mask_conv1", "mask_conv2", "mask_conv3", "mask_conv4", "mask_deconv",
                "mask_out"]
SWIZZLE_BYTES = 128   # the kernel's k-step and the swizzle's period
CIN_TILE = 128        # input channels of a k-step (BK in csrc/fused_mask_branch.cu)
CO_TILE = 256         # output channels of a GEMM block (BN there)


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def _swizzle_index(n: int, kp: int):
    """[n, kp/16] chunk positions: chunk j of row r of a 128-byte block sits
    at chunk j ^ (r % 8) of that block (an involution, so the same index
    packs and unpacks)."""
    j = np.arange(kp // 16)
    return (j // 8) * 8 + ((j % 8)[None, :] ^ (np.arange(n) % 8)[:, None])


def swizzle_nk(w_kn):
    """int8 [K, N] (rows in the plain version's im2col order) → the kernel's
    [N, Kp]: K-contiguous rows zero-padded to a multiple of 128 bytes, each
    128-byte block's 16-byte chunks in the swizzled order."""
    k, n = w_kn.shape
    kp = -(-k // SWIZZLE_BYTES) * SWIZZLE_BYTES
    rows = np.zeros((n, kp), np.int8)
    rows[:, :k] = np.asarray(w_kn, np.int8).T
    chunks = rows.reshape(n, kp // 16, 16)
    out = np.empty_like(chunks)
    np.put_along_axis(out, _swizzle_index(n, kp)[..., None], chunks, axis=1)
    return out.reshape(n, kp)


def unswizzle_nk(w_nk, k: int):
    """swizzle_nk's inverse on a tensor: [N, Kp] → [K, N] (a transposed view)."""
    n, kp = w_nk.shape
    idx = torch.as_tensor(_swizzle_index(n, kp), device=w_nk.device)
    chunks = torch.gather(w_nk.reshape(n, kp // 16, 16), 1, idx[..., None].expand(-1, -1, 16))
    return chunks.reshape(n, kp)[:, :k].t()


def pack_mask_weights(graph, num_classes: int):
    """The quant graph's mask layers as the kernel's operands (numpy), with
    Cf padded to Cp (a multiple of CIN_TILE) and co to cp = CO_TILE by zero
    channels: w1 int8 [cp, 9·Cp], w2..w4 int8 [cp, 9·cp] and wd int8
    [4·cp, cp], swizzled K-contiguous rows (swizzle_nk of the im2col
    matrices with rows in (di, dj, ci) order and of the deconv's [cp, 4·cp],
    columns in (di, dj, o) order), wo [4·cp, 4·nc] f32 holding bf16 values
    (block-diagonal), wsc [5, 4·cp] and bias [6, 4·cp] f32 (zero where
    padded), asc [6] f32 activation scales. The deconv's orientation is the
    graph's (quant._mask_layers). unpack_mask_weights gives back the plain
    matrices at the padded widths."""
    layers = graph["mask"]
    assert [l.name for l in layers] == _LAYER_NAMES
    convs, deconv, out = layers[:4], layers[4], layers[5]
    if any(not isinstance(l.a_scale, float) for l in (*convs, deconv, out)):
        raise NotImplementedError(
            "the fused mask kernel takes per-tensor activation scales only "
            "(calibrate without QUANT_PER_CHANNEL_ACT)")
    cf = int(convs[0].kernel.shape[2])
    co = int(convs[0].kernel.shape[3])
    if co > CO_TILE:
        raise ValueError(f"the fused mask kernel takes at most {CO_TILE} conv channels, "
                         f"got {co}")
    cfp, cop, nc = _round_up(cf, CIN_TILE), CO_TILE, num_classes

    def conv_matrix(w_q, cin, cin_p):
        w = np.zeros((3, 3, cin_p, cop), np.int8)
        w[:, :, :cin, :co] = np.asarray(w_q).reshape(3, 3, cin, co)
        return w.reshape(9 * cin_p, cop)

    ws = [conv_matrix(convs[0].w_q, cf, cfp)]
    ws += [conv_matrix(l.w_q, co, cop) for l in convs[1:]]
    wd = np.zeros((cop, 4, cop), np.int8)
    wd[:co, :, :co] = np.asarray(deconv.w_q).reshape(co, 4, co)
    wd = wd.reshape(cop, 4 * cop)
    wo = np.zeros((4, cop, 4 * nc), np.float32)
    wo[:, :co] = torch.tensor(np.asarray(out.kernel, np.float32).reshape(4, co, 4 * nc)
                              ).to(torch.bfloat16).float().numpy()
    wo = wo.reshape(4 * cop, 4 * nc)
    wsc = np.zeros((5, 4, cop), np.float32)
    bias = np.zeros((6, 4, cop), np.float32)
    for i, l in enumerate(convs):
        wsc[i, 0, :co] = l.w_scale
        bias[i, 0, :co] = l.bias
    wsc[4, :, :co] = np.asarray(deconv.w_scale, np.float32).reshape(4, co)
    bias[4, :, :co] = np.asarray(deconv.bias, np.float32).reshape(4, co)
    wsc, bias = wsc.reshape(5, 4 * cop), bias.reshape(6, 4 * cop)
    bias[5, :4 * nc] = out.bias
    asc = np.asarray([l.a_scale for l in convs] + [deconv.a_scale, out.a_scale], np.float32)
    return {"w1": swizzle_nk(ws[0]), "w2": swizzle_nk(ws[1]), "w3": swizzle_nk(ws[2]),
            "w4": swizzle_nk(ws[3]), "wd": swizzle_nk(wd), "wo": wo, "wsc": wsc,
            "bias": bias, "asc": asc}


def packed_widths(weights):
    """(Cp, cp): the padded fmap depth and conv width of packed weights."""
    return weights["w1"].shape[1] // 9, weights["w1"].shape[0]


def unpack_mask_weights(weights, cf: int | None = None, co: int | None = None):
    """The plain matrices from the packed ones (tensors): w1 [9·cf, co],
    w2..w4 [9·co, co], wd [co, 4·co] int8, cut to the fmap depth `cf` and
    conv width `co` (None: the padded widths, which the plain version
    multiplies by)."""
    cfp, cop = packed_widths(weights)
    cf, co = cf or cfp, co or cop
    conv = lambda name, cin_p, cin: unswizzle_nk(weights[name], 9 * cin_p).reshape(  # noqa: E731
        9, cin_p, cop)[:, :cin, :co].reshape(9 * cin, co)
    out = {name: conv(name, cop, co) for name in ("w2", "w3", "w4")}
    out["w1"] = conv("w1", cfp, cf)
    out["wd"] = unswizzle_nk(weights["wd"], cop).reshape(cop, 4, cop)[:co, :, :co].reshape(
        co, 4 * co)
    return out


def _pad_channels(x, to: int):
    """x with zero channels appended up to `to` (x itself when it has them)."""
    return x if x.shape[-1] == to else F.pad(x, (0, to - x.shape[-1]))


def weights_to(weights, device):
    """pack_mask_weights' arrays as tensors on `device` (wo in bf16; asc
    stays numpy: the kernel takes the scales as arguments)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in weights.items() if k != "asc"}
    out["wo"] = out["wo"].to(torch.bfloat16)
    out["asc"] = np.asarray(weights["asc"], np.float32)
    return out


def _conv3x3_rois(x_q, w, pool: int):
    """int8 [N·P², C] rows of N ROI tiles → int32 [N·P², co]: SAME 3×3 conv
    of each zero-padded P×P tile (im2col rows in (di, dj, ci) order)."""
    c = x_q.shape[-1]
    xp = F.pad(x_q.reshape(-1, pool, pool, c), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, di:di + pool, dj:dj + pool] for di in range(3)
                      for dj in range(3)], dim=-1)
    return int_mm(cols.reshape(-1, 9 * c), w)


def fused_mask_branch_reference(fmap, boxes, classes, weights, pool: int, num_classes: int):
    """Plain PyTorch version of the kernel, on any device."""
    b, k = boxes.shape[:2]
    asc = [float(s) for s in np.asarray(weights["asc"], np.float32)]
    wsc, bias = weights["wsc"], weights["bias"]
    cfp, co = packed_widths(weights)
    plain = unpack_mask_weights(weights)
    crops = crop_and_resize(fmap.to(torch.bfloat16), boxes.float(), (pool, pool)).float()
    x_q = _pad_channels(quantize(crops.reshape(b * k * pool * pool, -1), asc[0]), cfp)
    for li, name in enumerate(("w1", "w2", "w3", "w4")):
        acc = _conv3x3_rois(x_q, plain[name], pool)
        y = torch.relu(acc.float() * (wsc[li, :co] * asc[li]) + bias[li, :co])
        x_q = quantize(y, asc[li + 1])
    acc = int_mm(x_q, plain["wd"])
    y = torch.relu(acc.float() * (wsc[4] * asc[4]) + bias[4])
    y_q = quantize(y, asc[5])
    yb = y_q.to(torch.bfloat16) * torch.tensor(asc[5], dtype=torch.bfloat16)
    logits = yb.float() @ weights["wo"].float() + bias[5, :4 * num_classes]
    probs = torch.sigmoid(logits).reshape(b * k, pool * pool, 4, num_classes)
    cls = classes.reshape(b * k).long()[:, None, None, None].expand(-1, pool * pool, 4, 1)
    sel = torch.gather(probs, -1, cls)[..., 0].to(torch.bfloat16).float()  # [N, P², 4]
    m = sel.reshape(b, k, pool, pool, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return m.reshape(b, k, 2 * pool, 2 * pool)


def _kernel():
    fn = _build.load("fused_mask_branch").fused_mask_branch
    # fmap, boxes, classes, w1..w4, wd, wout, wsc, bias, x0, xa, xb, out (15 pointers),
    # B, H, W, Cf, K, P, co, nc, ld (9 ints), asc0..asc5 (6 floats), stream
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_mask_branch(fmap, boxes, classes, weights, pool: int = 14, num_classes: int = 2):
    """Fused int8 mask branch.

    fmap: [B, H, W, Cf] float (the neck output); boxes: [B, K, 4] f32
    normalized (x1, y1, x2, y2); classes: [B, K] integer; weights:
    weights_to(pack_mask_weights(...), device). Returns [B, K, 2·pool,
    2·pool] f32 sigmoid masks of each ROI's class. Inference only."""
    if fmap.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or tuple(classes.shape) != tuple(boxes.shape[:2]) \
            or boxes.shape[0] != fmap.shape[0]:
        raise ValueError(f"expected fmap [B, H, W, C], boxes [B, K, 4], classes [B, K]; got "
                         f"{tuple(fmap.shape)}, {tuple(boxes.shape)}, {tuple(classes.shape)}")
    if boxes.dtype != torch.float32 or classes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"boxes must be float32 and classes integer, got {boxes.dtype}, "
                        f"{classes.dtype}")
    if not (fmap.device == boxes.device == classes.device == weights["w1"].device):
        raise ValueError("fmap, boxes, classes and weights must share a device")
    co, cf = CO_TILE, _round_up(fmap.shape[-1], CIN_TILE)
    expect = {"w1": ((co, 9 * cf), torch.int8), "w2": ((co, 9 * co), torch.int8),
              "w3": ((co, 9 * co), torch.int8), "w4": ((co, 9 * co), torch.int8),
              "wd": ((4 * co, co), torch.int8),
              "wo": ((4 * co, 4 * num_classes), torch.bfloat16),
              "wsc": ((5, 4 * co), torch.float32), "bias": ((6, 4 * co), torch.float32)}
    for name, (shape, dtype) in expect.items():
        t = weights[name]
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != fmap.device:
            raise ValueError(f"weights[{name!r}]: expected packed {dtype} {shape} on "
                             f"{fmap.device} for Cf={fmap.shape[-1]}, "
                             f"num_classes={num_classes}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"weights[{name!r}] must be contiguous (the packed layout)")
    if fmap.device.type == "cpu":
        return fused_mask_branch_reference(fmap, boxes, classes, weights, pool, num_classes)
    if fmap.device.type != "cuda":
        raise ValueError(f"fused_mask_branch runs on cpu or cuda tensors, got {fmap.device}")
    b, h, w, _ = fmap.shape
    k = boxes.shape[1]
    out = torch.empty((b, k, 2 * pool, 2 * pool), dtype=torch.float32, device=fmap.device)
    if out.numel() == 0:
        return out
    m = b * k * pool * pool
    fmap = _pad_channels(fmap.to(torch.bfloat16), cf).contiguous()
    boxes = boxes.contiguous()
    classes = classes.to(torch.int32).contiguous()
    wout = weights["wo"][:co, :num_classes].contiguous()   # block 0 of the class conv
    x0 = torch.empty((m, cf), dtype=torch.int8, device=fmap.device)
    xa = torch.empty((m, co), dtype=torch.int8, device=fmap.device)
    xb = torch.empty((m, co), dtype=torch.int8, device=fmap.device)
    ptrs = [fmap, boxes, classes, weights["w1"], weights["w2"], weights["w3"], weights["w4"],
            weights["wd"], wout, weights["wsc"], weights["bias"], x0, xa, xb, out]
    with torch.cuda.device(fmap.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(*[t.data_ptr() for t in ptrs], b, h, w, cf, k, pool, co, num_classes,
                       4 * co, *[float(s) for s in weights["asc"]], stream)
    if rc != 0:
        raise RuntimeError(f"fused_mask_branch kernel launch failed with CUDA error {rc}")
    fused_mask_branch.launches += 1
    return out


fused_mask_branch.launches = 0
