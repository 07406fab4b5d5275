#!/usr/bin/env python3
"""Run the PyTorch port (`mask_yolo_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs CUDA and nvcc
    python3 chip_smoke.py --shapes-quality
                                   # instead of the phases: train Shapes at the
                                   # JAX package's budget (400 images, 40 epochs,
                                   # flip-only augmentation, AP callback every 5
                                   # epochs) in f32 and in bf16 and evaluate on
                                   # 50 held-out images (box and mask AP50)
    python3 chip_smoke.py --parent-csrc DIR
                                   # also build whichever of crop_rois.cu,
                                   # fused_ds_block.cu and fused_mask_branch.cu DIR
                                   # holds and time them against the current
                                   # kernels, in turns (old, new, new, old), e.g.
                                   # git show <commit>:mask_yolo_tpu_torch/csrc/<file>
                                   # > build/parent_csrc/<file>. The crop's C
                                   # interface is 0aa2710's (backward scratch
                                   # 32*B*K*P bytes), K1's and K3's 112676f's
                                   # (the weight layouts ParentKernels passes)

Phases, each fatal on failure (nothing is caught):
  1. device      the card's name and power limit; TF32 off for f32 references
  2. build       the CUDA crop kernel (K2) from mask_yolo_tpu_torch/csrc, with
                 ptxas's registers, shared memory and spills
  3. kernel      K2 vs its plain PyTorch twin at five shapes (FWD_SHAPES: the
                 detect path's in bf16 and f32, batch 128, the training path's
                 K=32 in f32, CocoStyleConfig's 52² with K=48), with CUDA-event
                 times back to back (L2 warm) and cycling through input and
                 output copies past 100 MB (cold), the parent's in turns, and
                 the F.grid_sample yardstick (library_ms; held to the plain
                 version at f32)
  4. slice       MaskYOLO.detect_batch at 224² (ShapesConfig widths) in bf16
                 and f32; the kernel's launches are counted, and the same
                 trunk outputs go through the plain-crop mask branch too
  5. serve       BatchingExecutor(batch_size=16) answers 24 requests
  6. throughput  detect_batch at batch 128 bf16, CUDA events (recorded only)
  7. build       the int8 kernels K1 (fused DS block) and K3 (fused mask
                 branch), compiled in parallel while phases 2-6 run
  8. kernels     K1 and K3 vs their plain PyTorch versions at the 224²
                 slice's shapes at batch 16 and 128 (K3 at K=10) and at
                 CocoStyleConfig's 416² shapes: K1 bit-equal (int8) or within
                 rtol 1e-6 (f32 out), K3 within the bounds of
                 tests/test_pallas_mask.py; CUDA-event times beside each
                 kernel's bound and torch._int_mm on the same GEMM shapes (a
                 yardstick of the tensor cores, not the kernels' function)
  9. int8 slice  MaskYOLO.quantize + detect_batch at 224² with K1 and K3
                 (exactly 10 K1 launches and 1 K3 launch), held against the
                 same detector's chained layers
 10. serve       BatchingExecutor over the int8 model answers 16 requests
 11. throughput  int8 detect_batch at batch 128, fused and chained, and the
                 fused one's split into trunk, K1, K3 and the rest (recorded)
 T1. kernel      the crop kernel's backward (K2 backward) vs its plain version,
                 f32, at the training shape (B=16, K=32, 28x28x256, P=14) and
                 at CocoStyleConfig's (B=4, K=128, 52x52x256), with off-map,
                 zero-area and mirrored boxes; two runs bit-identical; its
                 index kernel's band lists and column ranges, read from the
                 scratch, equal to roi_crop.backward_index's; times
                 beside the parent's and autograd through F.grid_sample
                 (library_ms, held to the plain version)
  R.  repairs    the widths the kernels used to refuse, against their plain
                 versions: K2 backward at C = 6 and 16 with P = 4 and 65 (f32
                 and bf16), K3 at Cf = 16 with co = 16 and 256 and at Cf = 200
                 (pool 4; zero channels are packed up to the kernel's tiles)
 T2. training    MaskYOLO("training", ShapesConfig widths, f32).train on a
                 seeded Shapes dataset (64 train, 16 val images) for 2 epochs:
                 exactly one K2 forward per train and validation step and one
                 K2 backward per train step, no plain crop on the card;
                 resume_from the epoch-1 checkpoint restores exactly; 25 steps
                 on one batch (lr 1e-4) cut the loss below 0.7x; a yolo-mode step; ms per
                 train step at batch 16 and peak memory (recorded)

 T3. bf16 train  the bf16 K2 backward vs its plain version at both T1 shapes
                 (within one bf16 ULP of the largest value, two runs
                 bit-identical), timed beside its bound and autograd through
                 F.grid_sample in bf16; then T2's training run, overfit and step
                 time with COMPUTE_DTYPE bfloat16 on f32 master weights
 Y1. infer_yolo  MaskYOLO.infer_yolo and infer_yolo_outputs at 224², batch 128,
                 bf16 and int8 (exactly 10 K1 launches a batch, no K2, no K3),
                 and at 416² with CocoStyleConfig's own knobs; the card's f32
                 result held to the port's CPU run at batch 4; ms per batch
                 and its split into trunk, decode and NMS, with the NMS's
                 chain length and launches
 D1. data        the native image library built and in use; host ms per batch
                 of BatchGenerator and of data_generator with default_augmenter
                 at DATA_WORKERS 0 and 4; one epoch of train(augmentation=,
                 profile_dir=) with DATA_WORKERS 2 leaves a trace
 E1. evaluate    evaluate_dataset on the model T2 trained, and the AP callback
                 with every=1 inside D1's train: every metric finite, in [0, 1]

The last three lines are the `nvidia-smi` name/power-limit line, a JSON line
of kernels (times, launches per path, bounds), and {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 and prints no result.

A bound is the least time the card could take for the kernel's work: the
larger of the bytes it must move (each input read once, each output written
once) over HBM's 3.35 TB/s and its operations over the peak rate of their
type (int8 1,979 TOP/s, bf16 989 TFLOP/s, f32 67 TFLOP/s; NVIDIA's data
sheet for the H100 SXM at 700 W).

Times are CUDA-event means over back-to-back calls behind a sleep kernel
that lets the host enqueue them all first (cuda_ms), so a kernel that runs
faster than Python launches it reads its device time; a call that
synchronises reads its wall time. K2's kernels (this tree's and the
parent's) are timed through their C entry points on buffers held here
(CropLib), so both run on the same inputs and outputs.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mask_yolo_tpu_torch import (CocoStyleConfig, MaskYOLO, evaluate_dataset,
                                 make_ap_eval_callback, native, quant)
from mask_yolo_tpu_torch.data import augment
from mask_yolo_tpu_torch.data.pipeline import BatchGenerator, data_generator, preload_dataset
from mask_yolo_tpu_torch.data.prefetch import to_device
from mask_yolo_tpu_torch.data.shapes import ShapesConfig, ShapesDataset
from mask_yolo_tpu_torch.ops import _build, nms, roi_crop
from mask_yolo_tpu_torch.ops import ds_block
from mask_yolo_tpu_torch.ops.ds_block import fused_ds_block, fused_ds_block_reference
from mask_yolo_tpu_torch.ops.mask_fused import (fused_mask_branch,
                                                fused_mask_branch_reference,
                                                pack_mask_weights, unpack_mask_weights,
                                                weights_to)
from mask_yolo_tpu_torch.ops.roi_align import (crop_and_resize, crop_and_resize_backward,
                                               interp_matrix)
from mask_yolo_tpu_torch.ops.roi_crop import crop_rois, crop_rois_backward
from mask_yolo_tpu_torch.pipelines import (detect_from_callables, images_f32,
                                           infer_yolo_from_callables, infer_yolo_outputs,
                                           training_loss)
from mask_yolo_tpu_torch.serve import BatchingExecutor
from mask_yolo_tpu_torch.train import state as train_state
from mask_yolo_tpu_torch.train import trainer
from mask_yolo_tpu_torch.utils.host_ops import BoundBox

SEED = 0
BATCH = 16
# K2 forward: the detect path's crop (bf16 as bench.py, and f32), batch 128
# (phase 6's batch), the training path's (f32, MASK_TRAIN_TOP_ROIS 32) and
# CocoStyleConfig's 416² (52x52x256, MASK_TOP_K 48); the first is the JSON
# line's headline shape
FWD_SHAPES = {
    "detect": dict(dtype=torch.bfloat16, b=16, h=28, w=28, c=256, k=10, pool=14),
    "detect_f32": dict(dtype=torch.float32, b=16, h=28, w=28, c=256, k=10, pool=14),
    "b128": dict(dtype=torch.bfloat16, b=128, h=28, w=28, c=256, k=10, pool=14),
    "train_f32": dict(dtype=torch.float32, b=16, h=28, w=28, c=256, k=32, pool=14),
    "coco416": dict(dtype=torch.bfloat16, b=4, h=52, w=52, c=256, k=48, pool=14),
}
COLD_BYTES = 100e6                 # cold timing cycles through copies past this (L2 is 50 MB)
CROP_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}        # max|Δ| / max|plain|
MASK_AGREE = 0.995
# the stride-1 DS blocks of the trunk (H, W, C, O, int8 output?): blocks 1, 3,
# 5, 6 (f32 out: it ends the backbone), 8-12 and 14 -> 10 K1 calls per trunk
DS_224 = [(112, 112, 32, 64, True), (56, 56, 64, 128, True), (28, 28, 256, 256, True),
          (28, 28, 256, 512, False)] + [(14, 14, 512, 512, True)] * 5 + [(7, 7, 1024, 1024, True)]
DS_416 = [(208, 208, 32, 64, True), (104, 104, 64, 128, True), (52, 52, 256, 256, True),
          (52, 52, 256, 512, False), (26, 26, 512, 512, True), (13, 13, 1024, 1024, True)]
K1_LAUNCHES, K3_LAUNCHES = 10, 1   # per int8 detect_batch
THROUGHPUT_BATCH = 128
HBM_BYTES_S = 3.35e12              # the H100 SXM's peaks (module docstring)
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
SLEEP_MAX_S = 0.25                 # cuda_ms's longest head start for the host
# the K2 backward at the training path's shape and at CocoStyleConfig's
BWD_SHAPES = [dict(b=16, h=28, w=28, c=256, k=32, pool=14),
              dict(b=4, h=52, w=52, c=256, k=128, pool=14)]
# max|kernel - plain| / max|plain|: f32 sums in another order; bf16 both round
# an f32 sum once, so they differ by at most one bf16 ULP of the largest value
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# widths the K2 backward's gather does not take (b, h, w, c, k, pool)
BWD_TAILS = [(2, 8, 8, 6, 8, 4), (2, 8, 8, 16, 8, 4), (1, 8, 8, 16, 4, 65), (1, 9, 7, 6, 4, 65)]
# K3 below its tiles (Cf, co, nc, pool): TinyConfig's mask branch, a narrow
# hand-built one, and a depth that is no multiple of 128
K3_TAILS = [(16, 256, 3, 4), (16, 16, 4, 4), (200, 256, 4, 14)]
INFER_CPU_BATCH = 4                # Y1: the card's f32 result against the CPU's
INFER_TOL = 1e-4                   # boxes (normalized) and scores, f32 card vs CPU
# 25 single-batch steps must cut the loss below 0.7x, the JAX package's bound
# (tests/test_train.py). At lr 1e-4: at ShapesConfig widths Adam at 1e-3 makes
# the exp-parametrized wh loss oscillate between ~4 and ~6e4 on one batch
# (the JAX package's yolo-mode test notes the same oscillation)
OVERFIT_STEPS, OVERFIT_BOUND, OVERFIT_LR = 25, 0.7, 1e-4


class Int8Config(ShapesConfig):
    """ShapesConfig at its full widths in bf16, with the int8 path's kernels:
    int8 depthwise convs (needed by K1), fused DS blocks (K1), fused mask
    branch (K3)."""
    COMPUTE_DTYPE = "bfloat16"
    QUANT_DW_INT8 = True
    QUANT_FUSED_DS = True
    QUANT_FUSED_MASK = True


class TrainConfig(ShapesConfig):
    """ShapesConfig at its full widths (f32, batch 16, TRAIN_BN, mini-masks,
    MASK_TRAIN_TOP_ROIS 32), with short epochs."""
    STEPS_PER_EPOCH = 2
    VALIDATION_STEPS = 1


class Coco416Config(CocoStyleConfig):
    QUANT_FUSED_DS = True
    QUANT_FUSED_MASK = True


class TrainBf16Config(TrainConfig):
    """TrainConfig computing in bf16 on f32 master weights."""
    COMPUTE_DTYPE = "bfloat16"


class DataConfig(ShapesConfig):
    """D1/E1: whole epochs from the endless generator on two loader workers."""
    DATA_WORKERS = 2
    VALIDATION_STEPS = 1


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of fn() over `iters` back-to-back calls. A sleep
    kernel holds the stream while the host enqueues them, longer than the
    warm-up calls took the host, so a call that the device finishes faster
    than Python launches it reads its device time, not the launch overhead
    (a call that synchronises reads its wall time as before)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # at most 2 GHz: the sleep lasts at least 1.5x the host's enqueue time
    torch.cuda._sleep(int(min(1.5 * iters * host_s, SLEEP_MAX_S) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops):
    """(bound_ms, "bytes" or "operations"): the larger of `nbytes` over HBM's
    rate and the operations ({type: count}) over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def crop_fmap_bytes(fmap, boxes, pool):
    """Bytes of the fmap pixels that some ROI's bilinear taps touch (with a
    non-zero weight): what the crop must read of its map."""
    b, h, w, c = fmap.shape
    rows = (interp_matrix(boxes[..., 1], boxes[..., 3], h, pool) != 0).any(-2)   # [B, K, H]
    cols = (interp_matrix(boxes[..., 0], boxes[..., 2], w, pool) != 0).any(-2)   # [B, K, W]
    touched = (rows[..., :, None] & cols[..., None, :]).any(1)                    # [B, H, W]
    return int(touched.sum().item()) * c * fmap.element_size()


def int_mm_ms(dev, m, k, n):
    """torch._int_mm on random int8 [m, k] x [k, n] (column-major), ms."""
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
    b = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev).t()
    return cuda_ms(lambda: torch._int_mm(a, b), 20, 3)


def random_boxes(rng, b, k):
    """Normalized (x1, y1, x2, y2) boxes; the first two of each image run off
    the map's edges."""
    x1 = rng.uniform(0.0, 0.6, (b, k))
    y1 = rng.uniform(0.0, 0.6, (b, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.05, 0.4, (b, k)),
                      y1 + rng.uniform(0.05, 0.4, (b, k))], axis=-1)
    boxes[:, 0] = [-0.5, -0.3, 0.5, 0.6]
    boxes[:, 1] = [0.6, 0.55, 1.4, 1.2]
    return boxes.astype(np.float32)


def sample_coords(lo, hi, size, pool):
    """interp_matrix's f32 sample coordinates c [..., pool] along an axis of
    `size` pixels, and whether each lies on the map."""
    n = size - 1
    if pool > 1:
        steps = torch.arange(pool, dtype=torch.float32, device=lo.device) / (pool - 1)
        c = lo[..., None] * n + steps * ((hi - lo)[..., None] * n)
    else:
        c = 0.5 * (lo + hi)[..., None] * n
    return c, (c >= 0) & (c <= n)


def grid_sample_operands(fmap, boxes, pool):
    """K2's function as one F.grid_sample call, the library yardstick (the
    port never calls it): (the fmap as an NCHW view, grid [B, K*P, P, 2] in
    the fmap's dtype, mask [B, K, P, P, 1] of the samples on the map).
    Needs H, W > 1."""
    b, h, w, _ = fmap.shape
    k = boxes.shape[1]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    cx, on_x = sample_coords(x1, x2, w, pool)                    # [B, K, P]
    cy, on_y = sample_coords(y1, y2, h, pool)
    gx = (2 * cx / (w - 1) - 1)[:, :, None, :].expand(b, k, pool, pool)
    gy = (2 * cy / (h - 1) - 1)[:, :, :, None].expand(b, k, pool, pool)
    grid = torch.stack([gx, gy], -1).reshape(b, k * pool, pool, 2).to(fmap.dtype)
    return fmap.permute(0, 3, 1, 2), grid, (on_y[..., :, None] & on_x[..., None, :])[..., None]


def grid_sample_crop(x, grid):
    """[B, C, K*P, P]: bilinear samples, coordinates clamped to the border."""
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=True)


def from_grid_layout(out, k, pool):
    """[B, C, K*P, P] -> [B, K, P, P, C]."""
    b, c = out.shape[:2]
    return out.reshape(b, c, k, pool, pool).permute(0, 2, 3, 4, 1)


def to_grid_layout(g):
    """[B, K, P, P, C] -> [B, C, K*P, P]."""
    b, k, pool, _, c = g.shape
    return g.permute(0, 4, 1, 2, 3).reshape(b, c, k * pool, pool)


def grid_sample_backward(fmap, boxes, g):
    """(d_fmap of K2's function through autograd of the yardstick, and a
    closure that recomputes it on the same graph, for timing)."""
    fmap = fmap.detach().requires_grad_()
    x, grid, mask = grid_sample_operands(fmap, boxes, g.shape[2])
    out = grid_sample_crop(x, grid)
    gm = to_grid_layout(g * mask)
    grad = lambda: torch.autograd.grad(out, fmap, gm, retain_graph=True)[0]   # noqa: E731
    return grad(), grad


class CropLib:
    """K2's forward and backward of one built library (this tree's or, with
    --parent-csrc, an earlier commit's), called through its C entry points
    on buffers the caller owns: for timing only, never a main path, so it
    counts no launches. scratch_bytes(b, h, w, k, pool): the bytes of
    scratch that library's backward takes."""

    def __init__(self, path, scratch_bytes, symbols=(
            "crop_rois_f32", "crop_rois_bf16", "crop_rois_backward_f32")):
        self.fns = roi_crop.bind(ctypes.CDLL(str(path)), symbols)
        self.scratch_bytes = scratch_bytes

    def _call(self, symbol, tensors, *dims):
        rc = self.fns[symbol](*(t.data_ptr() for t in tensors), *dims,
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{symbol} failed with CUDA error {rc}")

    def forward(self, fmap, boxes, out):
        b, h, w, c = fmap.shape
        self._call(roi_crop._SYMBOLS[fmap.dtype], (fmap, boxes, out), b, h, w, c,
                   out.shape[1], out.shape[2])

    def backward_scratch(self, g, hw):
        b, k, pool = g.shape[:3]
        return torch.empty(self.scratch_bytes(b, *hw, k, pool), dtype=torch.uint8,
                           device=g.device)

    def backward(self, g, boxes, scratch, out):
        b, k, pool, _, c = g.shape
        self._call(roi_crop._BWD_SYMBOLS[g.dtype], (g, boxes, scratch, out), b, out.shape[1],
                   out.shape[2], c, k, pool)


def time_turns(new, old=None, iters=50):
    """(new's ms, old's ms or None, the four or two readings): old, new,
    new, old in turns when there is an old."""
    if old is None:
        k1, k2 = cuda_ms(new, iters), cuda_ms(new, iters)
        return (k1 + k2) / 2, None, (k1, k2)
    o1, k1, k2, o2 = cuda_ms(old, iters), cuda_ms(new, iters), cuda_ms(new, iters), cuda_ms(old, iters)
    return (k1 + k2) / 2, (o1 + o2) / 2, (o1, k1, k2, o2)


def us(ms, readings):
    return f"{ms * 1e3:.2f} us (" + ", ".join(f"{r * 1e3:.2f}" for r in readings) + ")"


def check_crop(tag, fmap, boxes, pool, tol):
    """K2 through its wrapper vs its plain twin; returns max|Δ|."""
    got = crop_rois(fmap, boxes, pool).float()
    want = crop_and_resize(fmap, boxes, (pool, pool)).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ratio = err / want.abs().max().item()
    log(f"[kernel] K2 {tag}: max|kernel-plain| = {err:.3e}, / max|plain| = {ratio:.3e} "
        f"(limit {tol})")
    if not (torch.isfinite(got).all() and ratio <= tol):
        raise AssertionError(f"the crop kernel disagrees with its plain twin ({tag})")
    return err, want


def phase_kernel(dev, rng, new, parent=None):
    """K2 forward at each of FWD_SHAPES: the wrapper vs the plain twin, then
    times through `new` (and `parent`, a CropLib) warm and cold, the plain
    twin's and grid_sample's. Returns {shape tag: dict of the JSON keys}."""
    results = {}
    for tag, s in FWD_SHAPES.items():
        dtype, b, h, w, c, k, pool = (s[key] for key in ("dtype", "b", "h", "w", "c", "k", "pool"))
        what = f"{str(dtype)[6:]} B={b} K={k} {h}x{w}x{c} P={pool}"
        fmap = torch.tensor(rng.standard_normal((b, h, w, c), dtype=np.float32),
                            device=dev).to(dtype)
        if tag.startswith("detect"):   # and a prime K
            check_crop(f"{str(dtype)[6:]} B={b} K=7", fmap,
                       torch.tensor(random_boxes(rng, b, 7), device=dev), pool, CROP_TOL[dtype])
        boxes = torch.tensor(random_boxes(rng, b, k), device=dev)
        err, want = check_crop(what, fmap, boxes, pool, CROP_TOL[dtype])
        out = torch.empty_like(want, dtype=dtype)
        old_out = torch.empty_like(out)
        if parent:
            parent.forward(fmap, boxes, old_out)
            torch.cuda.synchronize()
            log(f"[kernel] K2 {what}: max|kernel-parent| = "
                f"{(old_out.float() - crop_rois(fmap, boxes, pool).float()).abs().max().item():.3e}")
        # warm: the same buffers back to back (the detect path's case: the
        # neck has just written the fmap); cold: copies cycled past COLD_BYTES
        ms, parent_ms, warm = time_turns(lambda: new.forward(fmap, boxes, out),
                                         parent and (lambda: parent.forward(fmap, boxes, old_out)))
        n = max(2, int(np.ceil(COLD_BYTES / nbytes(fmap, boxes, out))))
        bufs = [(fmap.clone(), boxes.clone(), torch.empty_like(out)) for _ in range(n)]
        cyc_new, cyc_old = itertools.cycle(bufs), itertools.cycle(bufs)
        cold_ms, cold_parent_ms, cold = time_turns(
            lambda: new.forward(*next(cyc_new)), parent and (lambda: parent.forward(*next(cyc_old))))
        del bufs, cyc_new, cyc_old
        plain = lambda: crop_and_resize(fmap, boxes, (pool, pool))   # noqa: E731
        p1 = cuda_ms(plain, 20)
        x, grid, mask = grid_sample_operands(fmap, boxes, pool)
        library_ms = cuda_ms(lambda: grid_sample_crop(x, grid))
        p2 = cuda_ms(plain, 20)
        lib_txt = "time only (its grid is bf16)"
        if dtype == torch.float32:
            lib_err = ((from_grid_layout(grid_sample_crop(x, grid), k, pool) * mask - want)
                       .abs().max().item() / want.abs().max().item())
            lib_txt = f"masked output vs plain {lib_err:.3e} of max (limit {CROP_TOL[dtype]})"
            if lib_err > CROP_TOL[dtype]:
                raise AssertionError(f"the grid_sample yardstick disagrees with the plain crop ({what})")
        out_elems = out.numel()
        # 9 f32 operations per output value: two taps in y at two columns, then x
        bnd = bound(crop_fmap_bytes(fmap, boxes, pool) + nbytes(boxes)
                    + out_elems * fmap.element_size(), {"f32": 9 * out_elems})
        old_txt = (f"; parent warm {us(parent_ms, warm[::3])}, cold {us(cold_parent_ms, cold[::3])}"
                   if parent else "")
        log(f"[kernel] K2 {what}: kernel warm {us(ms, warm[1:3] if parent else warm)}, cold "
            f"{us(cold_ms, cold[1:3] if parent else cold)} ({n} copies){old_txt}; plain "
            f"{us((p1 + p2) / 2, (p1, p2))}; grid_sample {library_ms * 1e3:.2f} us, {lib_txt}; "
            f"bound {bnd[0] * 1e3:.2f} us ({bnd[1]})")
        results[tag] = {"max_abs_err": err, "ms": ms, "cold_ms": cold_ms, "parent_ms": parent_ms,
                        "cold_parent_ms": cold_parent_ms, "plain_ms": (p1 + p2) / 2,
                        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms,
                        "at": what}
        del fmap, boxes, out, old_out, want, x, grid, mask
        torch.cuda.empty_cache()
    # edge shapes: channels that fill no 16-byte vector, one row or one
    # column, P = 1 or > 32
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, c, k, pool in ((2, 1, 5, 6, 3, 1), (1, 7, 1, 12, 2, 3), (1, 9, 70, 20, 3, 33)):
            fmap = torch.tensor(rng.standard_normal((b, h, w, c), dtype=np.float32),
                                device=dev).to(dtype)
            check_crop(f"{str(dtype)[6:]} B={b} K={k} {h}x{w}x{c} P={pool}", fmap,
                       torch.tensor(random_boxes(rng, b, k), device=dev), pool, CROP_TOL[dtype])
    return results


KERNELS = {"crop_rois": crop_rois, "crop_rois_backward": crop_rois_backward,
           "fused_ds_block": fused_ds_block, "fused_mask_branch": fused_mask_branch}


def run_main_path(fn, counts, expect=("crop_rois",)):
    """Drive a main path with every launch count zeroed just before and read
    just after; each kernel in `expect` must have launched. counts[name]
    collects the launches of each run."""
    for k in KERNELS.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    for name in expect:
        if KERNELS[name].launches == 0:
            raise AssertionError(f"the main path did not launch {name}")
    for name, k in KERNELS.items():
        counts.setdefault(name, []).append(k.launches)
    return out


def phase_slice(dtype_name, dev, images, counts):
    cfg = type("SmokeConfig", (ShapesConfig,), {"COMPUTE_DTYPE": dtype_name})()
    model = MaskYOLO("inference", cfg, seed=SEED, device=dev)
    out = run_main_path(lambda: model.detect_batch(images), counts)
    k, (h, w) = cfg.DETECTION_MAX_INSTANCES, cfg.IMAGE_SHAPE[:2]
    expect = {"boxes": ((BATCH, k, 4), torch.float32),
              "classes": ((BATCH, k), torch.int32),
              "scores": ((BATCH, k), torch.float32),
              "masks": ((BATCH, k, h, w), torch.bool),
              "valid": ((BATCH, k), torch.bool)}
    for key, (shape, dt) in expect.items():
        if tuple(out[key].shape) != shape or out[key].dtype != dt:
            raise AssertionError(f"{key}: {tuple(out[key].shape)} {out[key].dtype}, "
                                 f"expected {shape} {dt}")
    if not (torch.isfinite(out["scores"]).all() and torch.isfinite(out["boxes"]).all()):
        raise AssertionError("non-finite scores or boxes")

    # the same trunk outputs through the kernel and through the plain crop
    with torch.inference_mode():
        x = images_f32(torch.as_tensor(images, device=dev))
        grid, fmap = model.net.trunk(x)
        head = model.net.mask
        plain_branch = lambda rois, f: head.from_crops(crop_and_resize(    # noqa: E731
            f.to(head.dtype), rois.float(), (head.pool_size, head.pool_size)))
        out_k = detect_from_callables(lambda _: (grid, fmap), model.net.mask_branch, x, cfg)
        out_p = detect_from_callables(lambda _: (grid, fmap), plain_branch, x, cfg)
    for key in ("boxes", "classes", "scores", "valid"):
        if not torch.equal(out_k[key], out_p[key]):
            raise AssertionError(f"{key} differ between kernel and plain crop")
    agree = (out_k["masks"] == out_p["masks"]).float().mean().item()
    valid_px = out_k["masks"].sum().item()
    log(f"[slice] {dtype_name}: detect_batch B={BATCH} ok, {int(out['valid'].sum())} valid "
        f"detections, {valid_px} mask pixels; kernel-vs-plain crop masks agree on "
        f"{agree:.6f} of pixels (limit {MASK_AGREE}); crop launches {counts['crop_rois'][-1]}")
    if agree < MASK_AGREE:
        raise AssertionError("masks disagree between kernel and plain crop")
    return model, cfg


def phase_serve(model, cfg, rng, counts, n=24, expect=("crop_rois",), tag="serve"):
    ex = BatchingExecutor(model, cfg, batch_size=BATCH)
    try:
        ex.warmup(timeout=300)
        images = (rng.random((n, *cfg.IMAGE_SHAPE)) * 255).astype(np.uint8)

        def serve():
            futs = [ex.submit(im, include_masks=i % 3 == 0) for i, im in enumerate(images)]
            return [f.result(timeout=300) for f in futs]

        results = run_main_path(serve, counts, expect)
    finally:
        ex.shutdown()
    if len(results) != n or ex.stats["batches"] < 2:
        raise AssertionError(f"served {len(results)} requests in {ex.stats['batches']} batches")
    lat = ex.latency_ms
    n_masks = sum("mask_rle" in d for r in results for d in r["detections"])
    log(f"[{tag}] {n} requests answered, stats {ex.stats}, {n_masks} RLE masks; latency "
        f"p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms over {lat['n']} requests")


def phase_throughput(model, cfg, dev, rng, smi):
    images = torch.as_tensor((rng.random((128, *cfg.IMAGE_SHAPE)) * 255).astype(np.uint8),
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: model.detect_batch(images), iters=10, warmup=3)
    log(f"[throughput] detect_batch B=128 bf16 (uint8 input on device): {ms:.3f} ms/batch, "
        f"{128e3 / ms:.1f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB on {smi} (recorded, not claimed)")
    return ms


# ---- phases 7-11: the int8 path --------------------------------------------


def join_builds(pending, names):
    """Join the parallel nvcc builds of `names` (keys of `pending`); print
    seconds and what ptxas says of each kernel: registers, shared memory,
    spills. Returns {name: library path}."""
    libs = {}
    for name in names:
        lib, seconds = pending.pop(name).result()
        libs[name] = lib
        ptxas = [line.split("ptxas info    : ")[-1].strip()
                 for line in lib.with_suffix(".log").read_text().splitlines()
                 if "Used" in line or "spill" in line or "Compiling entry" in line]
        log(f"[build] {name}: {lib.name} in {seconds:.1f} s; ptxas: " + " | ".join(ptxas))
        if not name.startswith("parent"):
            _build.load(name)
    return libs


def timed_build(name, csrc=_build.CSRC):
    t0 = time.perf_counter()
    lib = _build.build(name, csrc)
    return lib, time.perf_counter() - t0


class ParentKernels:
    """K1 and K3 as commit 112676f built them (libraries from copies of its
    csrc/*.cu; either may be None), called with that commit's weight
    layouts: wpw [C, O]; w1..w4 [9 Cin, co] and wd [co, 4 co]. For timing
    against the current kernels only."""

    def __init__(self, ds_lib, mask_lib):
        self.ds = self.mask = None
        if ds_lib:
            self.ds = ctypes.CDLL(str(ds_lib)).fused_ds_block
            self.ds.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            self.ds.restype = ctypes.c_int
        if mask_lib:
            self.mask = ctypes.CDLL(str(mask_lib)).fused_mask_branch
            self.mask.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                                  + [ctypes.c_float] * 6 + [ctypes.c_void_p])
            self.mask.restype = ctypes.c_int

    def ds_block(self, x, kdw, dwsb, wpw_co, pwsb, a_pw, s_out):
        b, h, w, c = x.shape
        o = wpw_co.shape[1]
        out = torch.empty((b, h, w, o), dtype=torch.int8 if s_out else torch.float32,
                          device=x.device)
        rc = self.ds(x.data_ptr(), kdw.data_ptr(), dwsb.data_ptr(), wpw_co.data_ptr(),
                     pwsb.data_ptr(), out.data_ptr(), b, h, w, c, o,
                     ds_block.inv_scale(a_pw), ds_block.inv_scale(s_out) if s_out else 0.0,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the parent's K1 failed with CUDA error {rc}")
        return out

    @staticmethod
    def mask_weights(w, cf):
        """The current packed weights in the parent's layout."""
        old = dict(w)
        old.update({k: v.contiguous() for k, v in unpack_mask_weights(w, cf).items()})
        return old

    def mask_branch(self, fmap, boxes, classes, w_old, pool, nc):
        b, h, wd, cf = fmap.shape
        k = boxes.shape[1]
        co = w_old["w1"].shape[1]
        m = b * k * pool * pool
        fmap = fmap.to(torch.bfloat16).contiguous()
        out = torch.empty((b, k, 2 * pool, 2 * pool), dtype=torch.float32, device=fmap.device)
        scratch = [torch.empty((m, c), dtype=torch.int8, device=fmap.device)
                   for c in (cf, co, co)]
        ptrs = [fmap, boxes, classes.to(torch.int32), w_old["w1"], w_old["w2"], w_old["w3"],
                w_old["w4"], w_old["wd"], w_old["wo"][:co, :nc].contiguous(), w_old["wsc"],
                w_old["bias"], *scratch, out]
        rc = self.mask(*[t.data_ptr() for t in ptrs], b, h, wd, cf, k, pool, co, nc,
                       w_old["wsc"].shape[1], *[float(a) for a in w_old["asc"]],
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the parent's K3 failed with CUDA error {rc}")
        return out


def ds_operands(rng, dev, b, h, w, c, o):
    """Random K1 operands (wpw packed [O, C]) whose activations spread over
    relu6's range."""
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    x = t(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8))
    kdw = t(rng.integers(-127, 128, (9, c), dtype=np.int8))
    wpw = t(rng.integers(-127, 128, (o, c), dtype=np.int8))
    dwsb = t(np.stack([rng.uniform(0.5, 1.5, c) * 2.0 / 16129,
                       rng.normal(0, 0.5, c)]).astype(np.float32))
    pwsb = t(np.stack([rng.uniform(0.5, 1.5, o) * 2.0 / (np.sqrt(c) * 4400),
                       rng.normal(0, 0.5, o)]).astype(np.float32))
    return x, kdw, dwsb, wpw, pwsb


def check_k1(rng, dev, shapes, b, tag, parent=None):
    """K1 vs its plain version at each (H, W, C, O) of `shapes`; returns a
    dict: max |kernel - plain| over all, and the kernel's, the plain
    version's, the parent's (with `parent`) and the bound's ms summed over
    the list, i.e. one trunk's K1 calls."""
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "parent_ms": 0.0 if parent else None, "bound_by": {"bytes": 0.0, "operations": 0.0}}
    timed = {}
    for shape in shapes:
        h, w, c, o, int8_out = shape
        if shape not in timed:
            args = ds_operands(rng, dev, b, h, w, c, o)
            a_pw, s_out = 6.0 / 127, (6.0 / 127 if int8_out else 0.0)
            got = fused_ds_block(*args, a_pw=a_pw, s_out=s_out)
            want = fused_ds_block_reference(*args, a_pw=a_pw, s_out=s_out)
            torch.cuda.synchronize()
            if int8_out:
                d = (got.int() - want.int()).abs().max().item()
                ok = d == 0
                spread = ((want > 0) & (want < 127)).float().mean().item()
            else:
                d = (got - want).abs().max().item()
                ok = torch.allclose(got, want, rtol=1e-6, atol=0.0)
                spread = ((want > 0) & (want < 6)).float().mean().item()
            log(f"[kernel] K1 {tag} B={b} {h}x{w} {c}->{o} {'int8' if int8_out else 'f32'}: "
                f"max|kernel-plain| = {d} ({'bit-equal required' if int8_out else 'rtol 1e-6'}), "
                f"{spread:.3f} of outputs inside the clip range")
            if not (ok and spread > 0.05):
                raise AssertionError(f"K1 disagrees with its plain version at {h}x{w} {c}->{o}")
            res["max_abs_err"] = max(res["max_abs_err"], float(d))
            kernel = lambda: fused_ds_block(*args, a_pw=a_pw, s_out=s_out)             # noqa: E731
            plain = lambda: fused_ds_block_reference(*args, a_pw=a_pw, s_out=s_out)   # noqa: E731
            p1 = cuda_ms(plain, 10, 2)
            if parent:
                x, kdw, dwsb, wpw, pwsb = args
                wpw_co = wpw.t().contiguous()
                old = lambda: parent.ds_block(x, kdw, dwsb, wpw_co, pwsb, a_pw, s_out)  # noqa: E731
                if not torch.equal(old(), got):
                    raise AssertionError(f"the parent's K1 differs from K1 at {h}x{w} {c}->{o}")
                o1, k1, k2, o2 = (cuda_ms(old, 20, 3), cuda_ms(kernel, 20, 3),
                                  cuda_ms(kernel, 20, 3), cuda_ms(old, 20, 3))
            else:
                k1, k2 = cuda_ms(kernel, 20, 3), cuda_ms(kernel, 20, 3)
            p2 = cuda_ms(plain, 10, 2)
            npix = b * h * w
            bnd = bound(nbytes(*args) + npix * o * (1 if int8_out else 4),
                        {"int8": 2 * npix * (9 * c + c * o)})
            timed[shape] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bnd[0],
                            "parent_ms": (o1 + o2) / 2 if parent else None, "by": bnd[1]}
            old_txt = (f", parent {(o1 + o2) / 2 * 1e3:.1f} us ({o1 * 1e3:.1f}, {o2 * 1e3:.1f})"
                       if parent else "")
            log(f"[kernel] K1 {tag} B={b} {h}x{w} {c}->{o}: kernel {(k1 + k2) / 2 * 1e3:.1f} us "
                f"({k1 * 1e3:.1f}, {k2 * 1e3:.1f}), plain {(p1 + p2) / 2 * 1e3:.1f} us "
                f"({p1 * 1e3:.1f}, {p2 * 1e3:.1f}){old_txt}; bound {bnd[0] * 1e3:.2f} us "
                f"({bnd[1]})")
        for key in ("ms", "plain_ms", "bound_ms", "parent_ms"):
            if res[key] is not None:
                res[key] += timed[shape][key]
        res["bound_by"][timed[shape]["by"]] += timed[shape]["bound_ms"]
    # the sum's bound is set by whichever kind bounds more of its time
    res["bound_by"] = max(res["bound_by"], key=res["bound_by"].get)
    old_txt = f", parent {res['parent_ms']:.4f} ms" if parent else ""
    log(f"[kernel] K1 {tag} B={b}, the {len(shapes)} calls: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms{old_txt}, bound {res['bound_ms']:.4f} ms (mostly "
        f"{res['bound_by']})")
    return res


def mask_agreement(got, ref):
    """The bounds of tests/test_pallas_mask.py; returns the three numbers."""
    err = (got - ref).abs()
    decided = (ref - 0.5).abs() > 0.05
    agree = ((got >= 0.5) == (ref >= 0.5))[decided].float().mean().item()
    return err.mean().item(), (err > 0.05).float().mean().item(), agree, err.max().item()


def check_mask_agreement(got, want, what):
    mean, share, agree, worst = mask_agreement(got, want)
    decided = ((want - 0.5).abs() > 0.05).float().mean().item()
    log(f"[kernel] {what}: mean|d| {mean:.2e} (< 5e-3), share |d|>0.05 {share:.2e} (< 5e-3), "
        f"0.5-agreement {agree:.6f} (> 0.995) on the {decided:.3f} decided pixels; "
        f"max|d| {worst:.3e}")
    if not (torch.isfinite(got).all() and mean < 5e-3 and share < 5e-3 and agree > 0.995):
        raise AssertionError(f"{what} disagree")
    return worst


def k3_bound(fmap, boxes, classes, w, pool, nc):
    """K3's bound: its inputs and output once; int8 MACs of the four 3x3
    convs and the deconv, bf16 MACs of the class conv of each ROI's class."""
    b, k = boxes.shape[:2]
    cf, co = fmap.shape[-1], w["w1"].shape[0]
    m = b * k * pool * pool
    weights = nbytes(*[w[name] for name in ("w1", "w2", "w3", "w4", "wd", "wsc", "bias")])
    io = nbytes(fmap, boxes, classes) + weights + co * nc * 2 + b * k * (2 * pool) ** 2 * 4
    return bound(io, {"int8": 2 * m * (9 * cf * co + 3 * 9 * co * co + 4 * co * co),
                      "bf16": 2 * m * 4 * co})


def check_k3(rng, dev, det, cfg, b, k, tag, time_it=False, parent=None):
    """K3 vs its plain version on the detector's packed weights and trunk
    fmap, random boxes (two run off the map) and classes. Returns a dict of
    max |d|, and with time_it the kernel's, the plain version's, the
    parent's (with `parent`) and the bound's ms."""
    images = torch.as_tensor((rng.random((b, *cfg.IMAGE_SHAPE)) * 255).astype(np.uint8),
                             device=dev)
    with torch.inference_mode():
        fmap = det.trunk(images.float() / 255.0)[1]
    w = weights_to(pack_mask_weights(det.graph, cfg.NUM_CLASSES), dev)
    boxes = torch.as_tensor(random_boxes(rng, b, k), device=dev)
    classes = torch.as_tensor(rng.integers(0, cfg.NUM_CLASSES, (b, k)), dtype=torch.int32,
                              device=dev)
    pool, nc = cfg.MASK_POOL_SIZE, cfg.NUM_CLASSES
    got = fused_mask_branch(fmap, boxes, classes, w, pool, nc)
    want = fused_mask_branch_reference(fmap, boxes, classes, w, pool, nc)
    torch.cuda.synchronize()
    what = f"K3 {tag} B={b} K={k} {tuple(fmap.shape[1:])} nc={nc}"
    res = {"max_abs_err": check_mask_agreement(got, want, what)}
    if not time_it:
        return res
    kernel = lambda: fused_mask_branch(fmap, boxes, classes, w, pool, nc)             # noqa: E731
    plain = lambda: fused_mask_branch_reference(fmap, boxes, classes, w, pool, nc)    # noqa: E731
    p1 = cuda_ms(plain, 5, 1)
    if parent:
        w_old = parent.mask_weights(w, fmap.shape[-1])
        old = lambda: parent.mask_branch(fmap, boxes, classes, w_old, pool, nc)     # noqa: E731
        check_mask_agreement(old(), got, f"{what}: the parent's K3 vs K3")
        o1, k1, k2, o2 = (cuda_ms(old, 10, 2), cuda_ms(kernel, 10, 2), cuda_ms(kernel, 10, 2),
                          cuda_ms(old, 10, 2))
        res["parent_ms"] = (o1 + o2) / 2
    else:
        k1, k2 = cuda_ms(kernel, 10, 2), cuda_ms(kernel, 10, 2)
    p2 = cuda_ms(plain, 5, 1)
    m = b * k * pool * pool
    gemm = (int_mm_ms(dev, m, 9 * fmap.shape[-1], 256) + 3 * int_mm_ms(dev, m, 9 * 256, 256)
            + int_mm_ms(dev, m, 256, 1024))
    bnd = k3_bound(fmap, boxes, classes, w, pool, nc)
    res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bnd[0], bound_by=bnd[1],
               gemm_core_ms=gemm)
    rois, kc = b * k, 9 * fmap.shape[-1]
    old_txt = (f", parent {(o1 + o2) / 2:.3f} ms ({o1:.3f}, {o2:.3f})" if parent else "")
    log(f"[kernel] K3 {tag} B={b} K={k}: kernel {res['ms']:.3f} ms ({k1:.3f}, {k2:.3f}), "
        f"plain {res['plain_ms']:.3f} ms ({p1:.3f}, {p2:.3f}){old_txt}; bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); {rois} ROIs, {0.52 * rois / res['ms']:.1f} T int8 MAC/s (0.52 G MAC "
        f"per ROI at 224²); torch._int_mm on the same GEMM shapes ([{m}, {kc}] x "
        f"[{kc}, 256] + 3 x [{m}, 2304] x [2304, 256] + [{m}, 256] x [256, 1024]) "
        f"{gemm:.3f} ms (a yardstick)")
    return res


def spread_scores(model, by=8.0):
    """Scale the confidence and class rows of the seeded conv_23 by `by`.
    infer_yolo's score is confidence x class probability: at plain random
    weights the softmax over C classes stays near 1/C and nothing passes
    OBJ_THRESHOLD, so the per-class NMS would have no work (detect's score
    is the confidence alone). Returns the model."""
    w = model.net.yolo.conv_23.weight
    rows = torch.arange(w.shape[0], device=w.device) % (5 + model.config.NUM_CLASSES) >= 4
    with torch.no_grad():
        w[rows] *= by
    model._invalidate_infer_fns()
    model._sync_host_state()
    return model


def quantized_model(cfg, dev, spread=False):
    """The seeded model of `cfg` (with spread_scores if asked), quantized on
    8 seeded calibration images (as bench.py calibrates)."""
    model = MaskYOLO("inference", cfg, seed=SEED, device=dev)
    if spread:
        spread_scores(model)
    calib = np.random.RandomState(1).rand(8, *cfg.IMAGE_SHAPE).astype(np.float32)
    t0 = time.perf_counter()
    model.quantize(calib)
    torch.cuda.synchronize()
    log(f"[int8] {type(cfg).__name__}: quantize (BN fold, calibration on 8 images, int8 "
        f"weights) in {time.perf_counter() - t0:.1f} s")
    return model


def phase_kernels_int8(rng, dev, model224, cfg224, parent=None):
    """K1 and K3 vs plain at the 224² slice's shapes (batch 16 and 128) and
    at 416²; the GEMM-core yardstick of K1's widest pointwise product."""
    parent_k1 = parent if parent and parent.ds else None
    parent = parent if parent and parent.mask else None
    k1 = check_k1(rng, dev, DS_224, BATCH, "224", parent_k1)
    k1["b128"] = check_k1(rng, dev, DS_224, THROUGHPUT_BATCH, "224", parent_k1)
    check_k1(rng, dev, DS_416, 4, "416")
    for b, key in ((BATCH, None), (THROUGHPUT_BATCH, "b128")):
        gemm = int_mm_ms(dev, b * 7 * 7, 1024, 1024)
        log(f"[kernel] K1 yardstick: torch._int_mm [{b * 49}, 1024] x [1024, 1024] (the "
            f"7x7 block's pointwise product) {gemm * 1e3:.1f} us")
        (k1[key] if key else k1)["gemm_core_ms"] = gemm
    k = cfg224.DETECTION_MAX_INSTANCES
    k3 = check_k3(rng, dev, model224._qdet, cfg224, BATCH, k, "224", True, parent)
    k3["b128"] = check_k3(rng, dev, model224._qdet, cfg224, THROUGHPUT_BATCH, k, "224", True,
                          parent)
    check_k3(rng, dev, model224._qdet, cfg224, 3, 47, "224")   # a prime K, ragged M
    cfg416 = Coco416Config()
    model416 = quantized_model(cfg416, dev)
    k3_416 = check_k3(rng, dev, model416._qdet, cfg416, 3, cfg416.MASK_TOP_K, "416", True)
    del model416
    torch.cuda.empty_cache()
    k3["max_abs_err"] = max(k3["max_abs_err"], k3["b128"]["max_abs_err"],
                            k3_416["max_abs_err"])
    k3["416"] = k3_416
    return k1, k3


def phase_int8_slice(model, float_model, cfg, images, counts):
    """detect_batch on the int8 path with K1 and K3, exact launch counts,
    then the same detector's chained layers (K2 crop) on the same images."""
    out = run_main_path(lambda: model.detect_batch(images), counts,
                        ("fused_ds_block", "fused_mask_branch"))
    n1, n3, n2 = (counts["fused_ds_block"][-1], counts["fused_mask_branch"][-1],
                  counts["crop_rois"][-1])
    if (n1, n3, n2) != (K1_LAUNCHES, K3_LAUNCHES, 0):
        raise AssertionError(f"launches K1 {n1}, K3 {n3}, K2 {n2}; expected "
                             f"{K1_LAUNCHES}, {K3_LAUNCHES}, 0")
    k, (h, w) = cfg.DETECTION_MAX_INSTANCES, cfg.IMAGE_SHAPE[:2]
    if tuple(out["masks"].shape) != (BATCH, k, h, w) or out["masks"].dtype != torch.bool:
        raise AssertionError(f"masks {tuple(out['masks'].shape)} {out['masks'].dtype}")
    if not (torch.isfinite(out["scores"]).all() and torch.isfinite(out["boxes"]).all()):
        raise AssertionError("non-finite int8 scores or boxes")
    x = torch.as_tensor(images, device=out["boxes"].device)
    with torch.inference_mode():
        for k_ in KERNELS.values():
            k_.launches = 0
        chained = model._qdet.detect_outputs(x, fused_mask=False, fused_ds=False)
        torch.cuda.synchronize()
        if (fused_ds_block.launches, fused_mask_branch.launches) != (0, 0) \
                or crop_rois.launches != 1:
            raise AssertionError("the chained comparison did not run the chained layers")
    for key in ("boxes", "classes", "scores", "valid"):
        if not torch.equal(out[key], chained[key]):
            raise AssertionError(f"{key} differ between the fused and the chained int8 path")
    agree = (out["masks"] == chained["masks"]).float().mean().item()
    log(f"[int8] detect_batch B={BATCH}: {int(out['valid'].sum())} valid detections, "
        f"{int(out['masks'].sum())} mask pixels; launches K1 {n1}, K3 {n3}, K2 {n2}; "
        f"fused vs chained: boxes, classes, scores, valid identical, masks agree on "
        f"{agree:.6f} of pixels (limit {MASK_AGREE})")
    if agree < MASK_AGREE:
        raise AssertionError("fused and chained int8 masks disagree")
    ref = float_model.detect_batch(images)
    matched = total = 0
    for b in range(BATCH):
        for j in torch.nonzero(out["valid"][b]).flatten().tolist():
            total += 1
            same = ref["valid"][b] & (ref["classes"][b] == out["classes"][b, j])
            bx, rb = out["boxes"][b, j], ref["boxes"][b]
            ix = (torch.minimum(bx[2], rb[:, 2]) - torch.maximum(bx[0], rb[:, 0])).clamp(min=0)
            iy = (torch.minimum(bx[3], rb[:, 3]) - torch.maximum(bx[1], rb[:, 1])).clamp(min=0)
            inter = ix * iy
            union = ((bx[2] - bx[0]) * (bx[3] - bx[1])
                     + (rb[:, 2] - rb[:, 0]) * (rb[:, 3] - rb[:, 1]) - inter)
            matched += int((same & (inter / union.clamp(min=1e-9) >= 0.5)).any())
    log(f"[int8] {matched} of {total} valid int8 detections match a bf16 float-path "
        f"detection (same class, IoU >= 0.5; recorded only, random weights)")


def phase_int8_throughput(model, cfg, dev, rng, smi, bf16_ms, k1_ms, k3_ms):
    """Fused and chained int8 detect_batch at batch 128, and the fused one's
    split: the trunk alone (with K1), K1's and K3's times from phase 8, and
    the rest (decode, NMS, select, paste)."""
    images = torch.as_tensor((rng.random((128, *cfg.IMAGE_SHAPE)) * 255).astype(np.uint8),
                             device=dev)
    det = model._qdet
    fused = lambda: det.detect_outputs(images, fused_mask=True, fused_ds=True)      # noqa: E731
    chained = lambda: det.detect_outputs(images, fused_mask=False, fused_ds=False)  # noqa: E731
    x = images_f32(images)
    torch.cuda.reset_peak_memory_stats()
    f1, c1, c2, f2 = (cuda_ms(fused, 5, 2), cuda_ms(chained, 5, 2), cuda_ms(chained, 5, 2),
                      cuda_ms(fused, 5, 2))
    with torch.inference_mode():
        trunk = cuda_ms(lambda: det.trunk(x, fused_ds=True), 5, 2)
    f, c = (f1 + f2) / 2, (c1 + c2) / 2
    log(f"[throughput] int8 detect_batch B=128 (uint8 input on device): fused K1+K3 "
        f"{f:.3f} ms/batch ({f1:.3f}, {f2:.3f}), {128e3 / f:.1f} img/s; chained "
        f"{c:.3f} ms/batch ({c1:.3f}, {c2:.3f}), {128e3 / c:.1f} img/s; bf16 float path "
        f"{bf16_ms:.3f} ms/batch (phase 6); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB on {smi} (recorded, not claimed)")
    log(f"[throughput] fused int8 split at B=128: trunk {trunk:.3f} ms (K1's ten calls "
        f"{k1_ms:.3f} ms, the plain int8 layers ~{trunk - k1_ms:.3f}), mask branch K3 "
        f"{k3_ms:.3f} ms (phase 8, K=10), the rest ~{f - trunk - k3_ms:.3f} ms")
    # device time under the profiler against the unprofiled wall time: the
    # share of the batch the device idles (the profiler stretches the host)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.device_time_total for e in events) / 3e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:6]
    log(f"[throughput] torch.profiler, 3 fused int8 batches: {busy:.3f} ms of device time a "
        f"batch against {f:.3f} ms unprofiled, the device idle ~{1 - busy / f:.1%}; most "
        f"device time: " + "; ".join(f"{e.key[:48]} {e.device_time_total / 3e3:.3f} ms "
                                     f"({e.count // 3} a batch)" for e in top))

# ---- phases T1-T2: the training path ----------------------------------------


def backward_boxes(rng, b, k):
    """random_boxes plus, in image 0, a zero-area box and a mirrored one
    (x2 < x1, y2 < y1)."""
    boxes = random_boxes(rng, b, k)
    boxes[0, 2] = [0.3, 0.4, 0.3, 0.4]
    boxes[0, 3] = [0.8, 0.7, 0.2, 0.1]
    return boxes


def check_backward_index(tag, scratch, boxes, hw, pool):
    """The index kernel's output, read from the backward's scratch, against
    its plain version `roi_crop.backward_index`: every band's list of sample
    rows, and every ROI's per-column px ranges, equal. Logs the lists'
    lengths, the gather's work per block, as the kernel counted them."""
    b, k = boxes.shape[:2]
    lists, first, count = roi_crop.index_from_scratch(scratch, b, *hw, k, pool)
    p_lists, p_first, p_count = roi_crop.backward_index(boxes, hw, pool)
    same = (torch.equal(first, p_first.cpu()) and torch.equal(count, p_count.cpu())
            and all(torch.equal(r, p.cpu()) for image, p_image in zip(lists, p_lists)
                    for r, p in zip(image, p_image)))
    lengths = [len(rows) for image in lists for rows in image]
    log(f"[train-kernel] K2 backward index {tag}: the kernel's lists and column ranges "
        f"{'equal' if same else 'DIFFER FROM'} the plain version's; sample rows the kernel "
        f"listed a band of {roi_crop.BWD_BAND_ROWS} fmap rows: mean {np.mean(lengths):.1f}, "
        f"max {max(lengths)}, over {len(lengths)} bands")
    if not same:
        raise AssertionError(f"the K2 backward's index kernel disagrees with backward_index ({tag})")


def check_backward(tag, g, boxes, hw):
    """K2 backward through its wrapper vs its plain version (on the upcast
    gradient, rounded once, for bf16) and vs itself; returns (max|d|, plain)."""
    tol = BWD_TOL[g.dtype]
    got = crop_rois_backward(g, boxes, hw)
    again = crop_rois_backward(g, boxes, hw)
    want = crop_and_resize_backward(g.float(), boxes, hw).to(g.dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ratio = err / max(want.float().abs().max().item(), 1e-30)
    same = torch.equal(got, again)
    ulps = f" ({ratio * 2 ** 7:.2f} bf16 ULP of the largest value)" if g.dtype == torch.bfloat16 else ""
    log(f"[train-kernel] K2 backward {str(g.dtype)[6:]} {tag}: max|kernel-plain| = {err:.3e}, "
        f"/ max|plain| = {ratio:.3e}{ulps} (limit {tol:.3e}); two runs "
        f"{'bit-identical' if same else 'DIFFER'}")
    if not (got.dtype == g.dtype and torch.isfinite(got.float()).all() and ratio <= tol and same):
        raise AssertionError(f"the K2 backward disagrees with its plain version or itself ({tag})")
    return err, want


def phase_train_kernel(dev, rng, new, dtype, parent=None):
    """K2 backward in `dtype` at each of BWD_SHAPES: the wrapper vs its plain
    version and against itself (two runs bit-identical), the index kernel's
    output vs its plain version, then times through `new` (and `parent`, a
    CropLib, f32 only), the plain version's and autograd through
    grid_sample's. Returns a list of dicts of the JSON keys, one a shape."""
    results = []
    name = str(dtype)[6:]
    for s in BWD_SHAPES:
        boxes = torch.tensor(backward_boxes(rng, s["b"], s["k"]), device=dev)
        g = torch.tensor(rng.standard_normal((s["b"], s["k"], s["pool"], s["pool"], s["c"]),
                                             dtype=np.float32), device=dev).to(dtype)
        hw = (s["h"], s["w"])
        tag = f"B={s['b']}, K={s['k']}, {s['h']}x{s['w']}x{s['c']}, P={s['pool']}"
        err, want = check_backward(tag, g, boxes, hw)
        out, old_out = torch.empty_like(want), torch.empty_like(want)
        scratch = new.backward_scratch(g, hw)
        new.backward(g, boxes, scratch, out)
        check_backward_index(tag, scratch, boxes, hw, s["pool"])
        old_scratch = parent.backward_scratch(g, hw) if parent else None
        if parent:
            parent.backward(g, boxes, old_scratch, old_out)
            torch.cuda.synchronize()
            log(f"[train-kernel] K2 backward {tag}: max|kernel-parent| = "
                f"{(old_out - out).abs().max().item():.3e}")
        ms, parent_ms, turns = time_turns(
            lambda: new.backward(g, boxes, scratch, out),
            parent and (lambda: parent.backward(g, boxes, old_scratch, old_out)), 20)
        plain = lambda: crop_and_resize_backward(g.float(), boxes, hw).to(dtype)   # noqa: E731
        p1 = cuda_ms(plain, 20)
        lib_grad, lib = grid_sample_backward(g.new_zeros((s["b"], *hw, s["c"])), boxes, g)
        lib_err = ((lib_grad.float() - want.float()).abs().max().item()
                   / want.float().abs().max().item())
        library_ms = cuda_ms(lib, 20)
        p2 = cuda_ms(plain, 20)
        # the yardstick adds in bf16 with atomics: time only there
        if dtype == torch.float32 and lib_err > BWD_TOL[dtype]:
            raise AssertionError(f"autograd through grid_sample disagrees with the plain "
                                 f"backward ({tag})")
        # 9 f32 operations per gradient value, as the forward's per output value
        bnd = bound(nbytes(g, boxes, want), {"f32": 9 * g.numel()})
        old_txt = f", parent {us(parent_ms, turns[::3])}" if parent else ""
        log(f"[train-kernel] K2 backward {name} {tag}: kernel "
            f"{us(ms, turns[1:3] if parent else turns)}{old_txt}; plain "
            f"{us((p1 + p2) / 2, (p1, p2))}; autograd through grid_sample {library_ms * 1e3:.2f} "
            f"us, its gradient vs plain {lib_err:.3e} of max"
            f"{'' if dtype == torch.float32 else ' (bf16 atomics: time only)'}; bound "
            f"{bnd[0] * 1e3:.2f} us ({bnd[1]})")
        results.append({"max_abs_err": err, "ms": ms, "parent_ms": parent_ms,
                        "plain_ms": (p1 + p2) / 2, "bound_ms": bnd[0], "bound_by": bnd[1],
                        "library_ms": library_ms, "at": f"{name}, {tag}"})
        del g, boxes, want, out, old_out, scratch, old_scratch, lib_grad, lib
        torch.cuda.empty_cache()
    # edge shapes: a map wider than one block's columns, one row or one
    # column, P = 1 or > 32, lists longer than the 256 entries a block holds
    # at once
    for b, h, w, c, k, pool in ((2, 20, 200, 68, 5, 7), (2, 1, 5, 8, 4, 1), (1, 7, 1, 12, 4, 3),
                                (1, 9, 70, 4, 4, 33), (1, 4, 6, 16, 64, 14)):
        boxes = torch.tensor(backward_boxes(rng, b, k), device=dev)
        g = torch.tensor(rng.standard_normal((b, k, pool, pool, c), dtype=np.float32),
                         device=dev).to(dtype)
        check_backward(f"B={b}, K={k}, {h}x{w}x{c}, P={pool}", g, boxes, (h, w))
    empty = crop_rois_backward(torch.zeros((2, 0, 14, 14, 8), dtype=dtype, device=dev),
                               torch.zeros((2, 0, 4), device=dev), (4, 4))
    if empty.shape != (2, 4, 4, 8) or empty.dtype != dtype or empty.any():
        raise AssertionError("the K2 backward of zero ROIs is not a zero map")
    # autograd reaches the kernel of the fmap's dtype
    fmap = torch.zeros((1, 4, 4, 8), dtype=dtype, device=dev, requires_grad=True)
    launches = crop_rois_backward.launches
    crop_rois(fmap, torch.tensor([[[0.1, 0.1, 0.9, 0.9]] * 2], device=dev), 2).sum().backward()
    if crop_rois_backward.launches != launches + 1 or fmap.grad.dtype != dtype \
            or not fmap.grad.float().sum().item() > 0:
        raise AssertionError(f"a {name} fmap's gradient did not go through the K2 backward")
    return results


def mask_graph(rng, cf, co, nc):
    """Six random quantized mask layers of the given widths, with scales that
    spread the activations over the int8 range."""
    def layer(name, shape, fan_in):
        return quant.Layer(name, "conv", np.zeros(shape, np.float32),
                           rng.normal(0, 0.2, shape[-1]).astype(np.float32),
                           w_q=rng.integers(-127, 128, shape, dtype=np.int8),
                           w_scale=(rng.uniform(0.5, 1.5, shape[-1]) / (73 * np.sqrt(fan_in))
                                    ).astype(np.float32), a_scale=1.0 / 40)
    layers = ([layer("mask_conv1", (3, 3, cf, co), 9 * cf)]
              + [layer(f"mask_conv{i}", (3, 3, co, co), 9 * co) for i in (2, 3, 4)]
              + [layer("mask_deconv", (1, 1, co, 4 * co), co),
                 layer("mask_out", (1, 1, 4 * co, 4 * nc), co)])
    out = np.zeros((4, co, 4, nc), np.float32)        # block-diagonal: one class conv,
    out[range(4), :, range(4)] = rng.normal(0, 4.0 / np.sqrt(co), (co, nc))   # at each (di, dj)
    layers[5].kernel = out.reshape(1, 1, 4 * co, 4 * nc)
    layers[5].bias = np.tile(rng.normal(0, 0.5, nc).astype(np.float32), 4)
    return {"mask": layers}


def phase_repairs(dev, rng):
    """The widths the kernels used to refuse, against their plain versions:
    K2 backward at BWD_TAILS (f32 and bf16), K3 at K3_TAILS."""
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, c, k, pool in BWD_TAILS:
            boxes = torch.tensor(backward_boxes(rng, b, k), device=dev)
            g = torch.tensor(rng.standard_normal((b, k, pool, pool, c), dtype=np.float32),
                             device=dev).to(dtype)
            check_backward(f"tail B={b}, K={k}, {h}x{w}x{c}, P={pool}", g, boxes, (h, w))
    for cf, co, nc, pool in K3_TAILS:
        w = weights_to(pack_mask_weights(mask_graph(rng, cf, co, nc), nc), dev)
        b, k, side = 3, 7, 2 * pool
        fmap = torch.tensor(rng.standard_normal((b, side, side, cf), dtype=np.float32), device=dev)
        boxes = torch.as_tensor(random_boxes(rng, b, k), device=dev)
        classes = torch.as_tensor(rng.integers(0, nc, (b, k)), dtype=torch.int32, device=dev)
        launches = fused_mask_branch.launches
        got = fused_mask_branch(fmap, boxes, classes, w, pool, nc)
        want = fused_mask_branch_reference(fmap, boxes, classes, w, pool, nc)
        torch.cuda.synchronize()
        what = f"K3 tail Cf={cf} co={co} nc={nc} pool={pool} B={b} K={k}"
        check_mask_agreement(got, want, what)
        spread = ((want - 0.5).abs() > 0.05).float().mean().item()
        log(f"[kernel] {what}: {'identical to' if torch.equal(got, want) else 'within the bounds of'}"
            f" the plain version; {spread:.3f} of the mask values away from 0.5")
        if fused_mask_branch.launches != launches + 1 or spread < 0.2:
            raise AssertionError(f"{what}: the kernel did not launch or the masks do not spread")


class PlainCropsOnCuda:
    """Counts calls of the crop's plain versions on CUDA tensors while
    active (there must be none on the training path)."""

    def __init__(self):
        self.calls = 0
        self.saved = {}

    def __enter__(self):
        for name in ("crop_and_resize", "crop_and_resize_backward"):
            fn = self.saved[name] = getattr(roi_crop, name)

            def counted(t, *a, _fn=fn, **kw):
                self.calls += t.is_cuda
                return _fn(t, *a, **kw)

            setattr(roi_crop, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(roi_crop, name, fn)


def shapes_dataset(count, seed, cfg):
    ds = ShapesDataset()
    ds.load_shapes(count, cfg.IMAGE_SHAPE[0], cfg.IMAGE_SHAPE[1], seed=seed)
    ds.prepare()
    return ds


def snapshot(state):
    """Host copies of a TrainState's params, BN statistics, moments, counts."""
    host = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}   # noqa: E731
    return {"params": host(state.params), "batch_stats": host(state.batch_stats),
            "mu": host(state.opt_state["mu"]), "nu": host(state.opt_state["nu"]),
            "count": state.opt_state["count"], "step": state.step}


def phase_train(dev, smi, counts, workdir, cfg):
    """MaskYOLO.train on the card in cfg's COMPUTE_DTYPE, resume, overfit, a
    yolo-mode step and the step time. Returns (the trained model, the
    step's ms, its peak MiB)."""
    dtype = cfg.COMPUTE_DTYPE
    t0 = time.perf_counter()
    train_ds, val_ds = shapes_dataset(64, SEED, cfg), shapes_dataset(16, SEED + 1, cfg)
    log(f"[train] Shapes dataset, 64 train and 16 val images at {cfg.IMAGE_SHAPE[0]}^2, in "
        f"{time.perf_counter() - t0:.1f} s")
    model = MaskYOLO("training", cfg, model_dir=str(workdir), seed=SEED, device=dev)
    if {p.dtype for p in model.net.parameters()} != {torch.float32}:
        raise AssertionError("a training model must hold f32 (master) parameters")
    trained = model
    epoch1 = {}
    keep = lambda epoch, metrics, val_loss, state: (                         # noqa: E731
        epoch1.update(snapshot(state)) if epoch == 0 else None)
    epochs = 2
    t0 = time.perf_counter()
    with PlainCropsOnCuda() as plain:
        run_main_path(lambda: model.train(train_ds, val_ds, 1e-3, epochs=epochs, verbose=False,
                                          custom_callbacks=[keep]),
                      counts, ("crop_rois", "crop_rois_backward"))
    fwd, bwd = counts["crop_rois"][-1], counts["crop_rois_backward"][-1]
    want = (epochs * (cfg.STEPS_PER_EPOCH + cfg.VALIDATION_STEPS), epochs * cfg.STEPS_PER_EPOCH)
    history = [json.loads(line) for line in open(workdir / "history.jsonl")]
    log(f"[train] MaskYOLO.train 2 epochs x {cfg.STEPS_PER_EPOCH} steps + {cfg.VALIDATION_STEPS} "
        f"val step, batch {cfg.BATCH_SIZE}, {dtype}, in {time.perf_counter() - t0:.1f} s: K2 forward "
        f"{fwd}, K2 backward {bwd} launches (expected {want[0]}, {want[1]}); plain crops on the "
        f"card {plain.calls}; loss by epoch {[round(h['loss'], 4) for h in history]}, val_loss "
        f"{[round(h['val_loss'], 4) for h in history]}")
    if (fwd, bwd) != want or plain.calls:
        raise AssertionError("the training path did not run through the K2 kernels as expected")
    if not all(np.isfinite([h["loss"], h["val_loss"]]).all() for h in history):
        raise AssertionError("non-finite training or validation loss")

    ckpt = sorted(workdir.glob("saved_model_*_e0001.pt"))[0]
    fresh = MaskYOLO("training", cfg, model_dir=str(workdir), seed=SEED + 1, device=dev)
    tx = train_state.make_optimizer(1e-3, cfg, dict(fresh.net.named_parameters()))
    restored, epoch = train_state.resume_train_state(
        str(ckpt), train_state.create_train_state(fresh.net, tx), tx)
    got = snapshot(restored)
    same = (epoch == 1 and all(got[k] == epoch1[k] for k in ("count", "step"))
            and all(torch.equal(got[k][n], epoch1[k][n])
                    for k in ("params", "batch_stats", "mu", "nu") for n in epoch1[k]))
    masters = {v.dtype for v in train_state.load_checkpoint(str(ckpt))["params"].values()}
    if masters != {torch.float32}:
        raise AssertionError(f"the checkpoint holds {masters}, not the f32 masters")
    log(f"[train] resume_from {ckpt.name}: epoch {epoch}, step {got['step']}, f32 params, BN "
        f"statistics and Adam moments {'restore exactly' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("resume did not restore the epoch-1 state exactly")

    gen = BatchGenerator(preload_dataset(train_ds, cfg), cfg, shuffle=False)
    batch = to_device(gen[0], dev)
    model = MaskYOLO("training", cfg, seed=SEED, device=dev)
    tx = train_state.make_optimizer(OVERFIT_LR, cfg, dict(model.net.named_parameters()))
    state = train_state.create_train_state(model.net, tx)
    step = trainer.make_train_step(cfg, tx)
    losses = [step(state, batch)[1]["loss"] for _ in range(OVERFIT_STEPS)]
    losses = torch.stack(losses).cpu().numpy()
    log(f"[train] overfit one batch, {OVERFIT_STEPS} steps at lr {OVERFIT_LR}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (bound < {OVERFIT_BOUND} x first)")
    if not (np.isfinite(losses).all() and losses[-1] < OVERFIT_BOUND * losses[0]):
        raise AssertionError("overfitting one batch did not cut the loss enough")

    yolo = MaskYOLO("yolo", cfg, seed=SEED, device=dev)
    ytx = train_state.make_optimizer(1e-3, cfg, dict(yolo.net.named_parameters()))
    ystate = train_state.create_train_state(yolo.net, ytx)
    launches = crop_rois.launches
    _, ym = trainer.make_train_step(cfg, ytx, "yolo")(ystate, batch)
    yloss = ym["loss"].item()
    log(f"[train] yolo-mode step: loss {yloss:.4f}, K2 launches {crop_rois.launches - launches}")
    if not (np.isfinite(yloss) and ystate.step == 1 and crop_rois.launches == launches):
        raise AssertionError("the yolo-mode step failed")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), iters=10, warmup=3)
    fwd_ms = cuda_ms(lambda: training_loss(state.net, batch, cfg, 1e9),
                     iters=10, warmup=2)
    params = state.params
    loss, _ = training_loss(state.net, batch, cfg, 1e9)
    grads = dict(zip(tx.keys, torch.autograd.grad(loss, [params[k] for k in tx.keys])))
    opt_ms = cuda_ms(lambda: tx.apply(params, grads, state.opt_state), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[train] train step at batch {cfg.BATCH_SIZE}, {cfg.IMAGE_SHAPE[0]}^2, {dtype} (TF32 off for "
        f"cuDNN and matmul): {ms:.3f} ms/step ({cfg.BATCH_SIZE * 1e3 / ms:.1f} img/s); forward "
        f"with autograd graph {fwd_ms:.3f} ms, optimizer {opt_ms:.3f} ms, so backward ~"
        f"{ms - fwd_ms - opt_ms:.3f} ms; peak memory {peak:.0f} MiB on {smi} (recorded, not "
        f"claimed)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.device_time_total for e in events) / 2e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    log(f"[train] torch.profiler, 2 {dtype} steps: {busy:.3f} ms of device time a step against "
        f"{ms:.3f} ms unprofiled, {sum(e.count for e in events) // 2} launches a step; most "
        f"device time: " + "; ".join(f"{e.key[:56]} {e.device_time_total / 2e3:.3f} ms "
                                     f"({e.count // 2} a step)" for e in top))
    return trained, ms, peak



# ---- phase Y1: infer_yolo ----------------------------------------------------


def device_kernels(fn):
    """(device ms, launches) of one call of fn under torch.profiler: the sum
    of its device activities' times, and how many there were."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    return sum(e.device_time_total for e in events) / 1e3, sum(e.count for e in events)


def infer_yolo_split(tag, trunk, images, cfg, smi):
    """ms per batch of infer_yolo on `trunk`, and its split: the trunk alone,
    decode (boxes, confidence, the reference's softmax, threshold) and the
    per-class NMS with the winning class, timed on this batch's own grid.
    The NMS reads its chain length from the device once, so its time is a
    wall time. Returns the total ms."""
    x = images_f32(images)
    with torch.inference_mode():
        total = cuda_ms(lambda: infer_yolo_from_callables(trunk, images, cfg), 5, 2)
        trunk_ms = cuda_ms(lambda: trunk(x), 5, 2)
        grid = trunk(x)[0]
        after = cuda_ms(lambda: infer_yolo_from_callables(lambda _: (grid, None), x, cfg), 5, 2)
        # the NMS alone, on the probabilities this grid gives
        boxes = infer_yolo_from_callables(lambda _: (grid, None), x, cfg)["boxes"]
        g = grid.float()
        probs = torch.sigmoid(g[..., 4])[..., None] * nms.reference_softmax(g[..., 5:],
                                                                            batch_dims=1)
        probs = (probs * (probs > cfg.OBJ_THRESHOLD)).reshape(g.shape[0], -1, cfg.NUM_CLASSES)
        n_top = int(cfg.INFER_YOLO_TOP_N or 0)
        k_cls = int(cfg.INFER_YOLO_PER_CLASS_K or 0)
        n = probs.shape[1]
        if k_cls and k_cls < n:
            run = lambda: nms.per_class_topk_nms(boxes, probs, k_cls, cfg.NMS_THRESHOLD)   # noqa: E731
            how = f"per-class top-{k_cls}"
        elif n_top and n_top < n:
            idx = torch.sort(probs.amax(-1), dim=-1, descending=True, stable=True)[1][:, :n_top]
            tb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
            tp = torch.gather(probs, 1, idx[..., None].expand(-1, -1, probs.shape[-1]))
            run = lambda: nms.class_aware_nms(tb, tp, cfg.NMS_THRESHOLD)                   # noqa: E731
            how = f"top-{n_top} of {n}"
        else:
            run = lambda: nms.class_aware_nms(boxes, probs, cfg.NMS_THRESHOLD)             # noqa: E731
            how = f"full grid of {n}"
        nms_ms = cuda_ms(run, 5, 2)
        nms_dev_ms, nms_launches = device_kernels(run)
        live = (probs > 0).sum(1)
    b = images.shape[0]
    log(f"[infer_yolo] {tag} B={b}: {total:.3f} ms/batch ({b * 1e3 / total:.1f} img/s); trunk "
        f"{trunk_ms:.3f} ms, decode ~{after - nms_ms:.3f} ms, NMS {nms_ms:.3f} ms ({how}, "
        f"{cfg.NUM_CLASSES} classes: a chain of {nms.greedy_keep.steps} steps, {nms_launches} "
        f"launches, {nms_dev_ms:.3f} ms of device time); boxes over OBJ_THRESHOLD a class and "
        f"image: max {int(live.max())}, mean {live.float().mean().item():.2f} on {smi} "
        f"(recorded, not claimed)")
    return total


def check_infer_outputs(out, b, cfg):
    n = cfg.GRID_H * cfg.GRID_W * cfg.N_BOX
    expect = {"boxes": ((b, n, 4), torch.float32), "scores": ((b, n), torch.float32),
              "classes": ((b, n), torch.int32), "valid": ((b, n), torch.bool)}
    for key, (shape, dt) in expect.items():
        if tuple(out[key].shape) != shape or out[key].dtype != dt:
            raise AssertionError(f"infer_yolo {key}: {tuple(out[key].shape)} {out[key].dtype}, "
                                 f"expected {shape} {dt}")
    if not (torch.isfinite(out["boxes"]).all() and torch.isfinite(out["scores"]).all()):
        raise AssertionError("non-finite infer_yolo boxes or scores")
    if (out["valid"] != (out["scores"] > cfg.OBJ_THRESHOLD)).any():
        raise AssertionError("infer_yolo valid is not scores > OBJ_THRESHOLD")


def phase_infer_yolo(dev, rng, smi, cfg, cfg8, counts):
    """Y1: infer_yolo through MaskYOLO and the pipelines, float and int8, at
    224² (batch 128) and at 416² (CocoStyleConfig's knobs, batch 16), on
    seeded models whose scores are spread (spread_scores)."""
    model = spread_scores(MaskYOLO("inference", cfg, seed=SEED, device=dev))
    model8 = quantized_model(cfg8, dev, spread=True)
    images = torch.as_tensor((rng.random((THROUGHPUT_BATCH, *cfg.IMAGE_SHAPE)) * 255)
                             .astype(np.uint8), device=dev)
    one = images[0].cpu().numpy()

    # the float path: MaskYOLO.infer_yolo on one image, the pipeline on the batch
    boxes = run_main_path(lambda: model.infer_yolo(one), counts, expect=())
    out = model._infer_yolo_batch(images)
    check_infer_outputs(out, THROUGHPUT_BATCH, cfg)
    if not all(isinstance(b, BoundBox) for b in boxes) or not out["valid"].any() \
            or len(boxes) != int(out["valid"][0].sum()):
        raise AssertionError("MaskYOLO.infer_yolo does not return the valid boxes as BoundBoxes")
    with torch.inference_mode():
        direct = infer_yolo_outputs(model.net, images, cfg)
    if not all(torch.equal(out[k], direct[k]) for k in out):
        raise AssertionError("MaskYOLO's infer_yolo differs from pipelines.infer_yolo_outputs")
    log(f"[infer_yolo] {cfg.COMPUTE_DTYPE} 224^2 B={THROUGHPUT_BATCH}: {int(out['valid'].sum())} "
        f"valid boxes of {out['valid'].numel()}, {len(boxes)} BoundBoxes for image 0; launches "
        f"K1 {counts['fused_ds_block'][-1]}, K2 {counts['crop_rois'][-1]}, K3 "
        f"{counts['fused_mask_branch'][-1]}")

    # the int8 path: exactly 10 K1 launches a batch, no K2, no K3
    out8 = run_main_path(lambda: model8._infer_yolo_batch(images), counts, ("fused_ds_block",))
    check_infer_outputs(out8, THROUGHPUT_BATCH, cfg8)
    n1, n2, n3 = (counts[k][-1] for k in ("fused_ds_block", "crop_rois", "fused_mask_branch"))
    boxes8 = model8.infer_yolo(one)
    chained = model8._qdet.infer_yolo_outputs(images, fused_ds=False)
    same = {k: torch.equal(out8[k], chained[k]) for k in ("classes", "valid")}
    close = (out8["boxes"] - chained["boxes"]).abs().max().item()
    log(f"[infer_yolo] int8 224^2 B={THROUGHPUT_BATCH}: {int(out8['valid'].sum())} valid boxes, "
        f"{len(boxes8)} BoundBoxes for image 0; launches K1 {n1}, K2 {n2}, K3 {n3} (expected "
        f"{K1_LAUNCHES}, 0, 0); against the chained int8 layers: classes and valid "
        f"{'identical' if all(same.values()) else 'DIFFER'}, max|d boxes| {close:.3e}")
    if (n1, n2, n3) != (K1_LAUNCHES, 0, 0) or not all(same.values()) or close > 0 \
            or len(boxes8) != int(out8["valid"][0].sum()):
        raise AssertionError("the int8 infer_yolo path did not run as expected")

    # the card's f32 result against the port's own CPU run
    cfg32 = type("InferF32Config", (ShapesConfig,), {"COMPUTE_DTYPE": "float32"})()
    small = images[:INFER_CPU_BATCH]
    on_card, on_cpu = (
        spread_scores(MaskYOLO("inference", cfg32, seed=SEED, device=d))._infer_yolo_batch(
            small.to(d)) for d in (dev, "cpu"))
    d_boxes = (on_card["boxes"].cpu() - on_cpu["boxes"]).abs().max().item()
    d_scores = (on_card["scores"].cpu() - on_cpu["scores"]).abs().max().item()
    same = all(torch.equal(on_card[k].cpu(), on_cpu[k]) for k in ("classes", "valid"))
    log(f"[infer_yolo] f32 224^2 B={INFER_CPU_BATCH}, the card against the CPU: max|d boxes| "
        f"{d_boxes:.3e}, max|d scores| {d_scores:.3e} (limit {INFER_TOL}), classes and valid "
        f"{'identical' if same else 'DIFFER'}; {int(on_cpu['valid'].sum())} valid boxes")
    if not (same and d_boxes <= INFER_TOL and d_scores <= INFER_TOL and on_cpu["valid"].any()):
        raise AssertionError("infer_yolo on the card disagrees with the CPU run")

    infer_yolo_split(f"{cfg.COMPUTE_DTYPE} 224^2", model.net.trunk, images, cfg, smi)
    infer_yolo_split("int8 224^2", lambda x: model8._qdet.trunk(x), images, cfg8, smi)
    del images, out, out8, chained, direct, model, model8
    torch.cuda.empty_cache()

    # 416^2, 81 classes, CocoStyleConfig's own knobs, float and int8
    cfg416 = Coco416Config()
    model416 = quantized_model(cfg416, dev, spread=True)
    images = torch.as_tensor((rng.random((BATCH, *cfg416.IMAGE_SHAPE)) * 255).astype(np.uint8),
                             device=dev)
    float416 = spread_scores(MaskYOLO("inference", cfg416, seed=SEED, device=dev))
    for tag, m in ((cfg416.COMPUTE_DTYPE, float416), ("int8", model416)):
        out = run_main_path(lambda m=m: m._infer_yolo_batch(images), counts,
                            ("fused_ds_block",) if m is model416 else ())
        check_infer_outputs(out, BATCH, cfg416)
        if not out["valid"].any():
            raise AssertionError("no box passed OBJ_THRESHOLD at 416^2: the NMS had no work")
        log(f"[infer_yolo] {tag} 416^2 B={BATCH}, INFER_YOLO_TOP_N {cfg416.INFER_YOLO_TOP_N}, "
            f"PER_CLASS_K {cfg416.INFER_YOLO_PER_CLASS_K}: {int(out['valid'].sum())} valid boxes "
            f"of {out['valid'].numel()}; launches K1 {counts['fused_ds_block'][-1]}, K2 "
            f"{counts['crop_rois'][-1]}, K3 {counts['fused_mask_branch'][-1]}")
        if counts["crop_rois"][-1] or counts["fused_mask_branch"][-1]:
            raise AssertionError("infer_yolo launched a mask-branch kernel")
    infer_yolo_split(f"{cfg416.COMPUTE_DTYPE} 416^2", float416.net.trunk, images, cfg416, smi)
    infer_yolo_split("int8 416^2", lambda x: model416._qdet.trunk(x), images, cfg416, smi)


# ---- phases D1 and E1: the data path and evaluation ---------------------------


def host_ms(make_batch, count):
    """Mean host milliseconds of `count` calls of make_batch() (after one)."""
    make_batch()
    t0 = time.perf_counter()
    for _ in range(count):
        make_batch()
    return (time.perf_counter() - t0) * 1e3 / count


def check_metrics(what, result):
    """Every AP and recall of an evaluate_dataset result finite and in [0, 1]."""
    keys = [k for k in result if k not in ("per_image", "n_images", "epoch")]
    bad = [k for k in keys if not (np.isfinite(result[k]) and 0.0 <= result[k] <= 1.0)]
    log(f"[evaluate] {what}: " + ", ".join(f"{k} {result[k]:.4f}" for k in keys)
        + f" over {result['n_images']} images (random or barely trained weights: not a "
          f"quality claim)")
    if bad or len(keys) < 8:
        raise AssertionError(f"{what}: metrics out of range or missing: {bad}")


def phase_data_and_evaluate(dev, smi, trained, counts, workdir):
    """D1: the native image library, host ms per batch of the two batch
    sources, and an epoch of train(augmentation=, profile_dir=) on loader
    workers that leaves a trace. E1: evaluate_dataset on the model T2 trained
    and the AP callback inside D1's train."""
    if not native.available():
        raise AssertionError("the native image library did not build on this machine")
    log(f"[data] native image ops built and in use: "
        f"{[p.name for p in native.BUILD_DIR.glob('image_ops_*.so')]}")
    cfg = DataConfig()
    t0 = time.perf_counter()
    train_ds, val_ds = shapes_dataset(96, SEED + 2, cfg), shapes_dataset(16, SEED + 3, cfg)
    data = preload_dataset(train_ds, cfg)
    preload_s = time.perf_counter() - t0
    gen = BatchGenerator(data, cfg, shuffle=True, seed=SEED)
    it = itertools.cycle(range(len(gen)))
    ms = {"BatchGenerator": host_ms(lambda: gen[next(it)], 24)}
    for workers in (0, 4):
        for mode in (("thread", "process") if workers else ("inline",)):
            wcfg = type("WorkersConfig", (DataConfig,),
                        {"DATA_WORKERS": workers, "DATA_WORKER_MODE": mode if workers else "thread"})()
            source = data_generator(train_ds, wcfg, augmentation=augment.default_augmenter(SEED),
                                    seed=SEED)
            try:
                ms[f"data_generator, {workers} workers ({mode})"] = host_ms(lambda: next(source), 12)
            finally:
                source.close()
    log(f"[data] host ms per batch of {cfg.BATCH_SIZE} at {cfg.IMAGE_SHAPE[0]}^2 (preload of 96 "
        f"images {preload_s:.2f} s; {len(os.sched_getaffinity(0))} CPU cores): "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
        + " (default_augmenter; the generator re-reads and re-augments every image)")

    # E1 on the model T2 trained: its weights into an inference model on the card
    infer = MaskYOLO("inference", trained.config, seed=SEED, device=dev)
    infer._load_live_state(dict(trained.net.named_parameters()),
                           {k: v for k, v in trained.net.named_buffers() if "running" in k})
    run_main_path(lambda: check_metrics(
        "evaluate_dataset on T2's model, score_threshold 0.05",
        evaluate_dataset(infer, val_ds, trained.config, batch_size=8, score_threshold=0.05)),
        counts)

    # D1's train: augmentation, two loader workers, a trace, the AP callback
    trace_dir = workdir / "trace"
    cb = make_ap_eval_callback(val_ds, cfg, every=1, batch_size=8, score_threshold=0.05,
                               history_path=str(workdir / "ap.jsonl"),
                               best_weights_path=str(workdir / "best.pt"), verbose=False)
    model = MaskYOLO("training", cfg, model_dir=str(workdir / "ckpt"), seed=SEED, device=dev)
    t0 = time.perf_counter()
    with PlainCropsOnCuda() as plain:
        state = run_main_path(lambda: model.train(
            train_ds, val_ds, 1e-3, epochs=1, verbose=False,
            augmentation=augment.default_augmenter(SEED), profile_dir=str(trace_dir),
            custom_callbacks=[cb]), counts, ("crop_rois", "crop_rois_backward"))
    steps = len(train_ds.image_ids) // cfg.BATCH_SIZE
    traces = sorted(trace_dir.glob("*.trace.json"))
    log(f"[data] train(augmentation=default_augmenter, profile_dir=) with DATA_WORKERS "
        f"{cfg.DATA_WORKERS}: 1 epoch of {state.step} steps in {time.perf_counter() - t0:.1f} s; "
        f"K2 forward {counts['crop_rois'][-1]}, backward {counts['crop_rois_backward'][-1]} "
        f"launches; plain crops on the card {plain.calls}; trace "
        f"{[f'{t.name} ({t.stat().st_size / 2**20:.1f} MiB)' for t in traces]}")
    if state.step != steps or counts["crop_rois_backward"][-1] != steps or plain.calls \
            or len(traces) != 1 or '"cat": "kernel"' not in traces[0].read_text():
        raise AssertionError("D1's train did not run as expected or left no device trace")
    if len(cb.history) != 1 or not (workdir / "best.pt").exists():
        raise AssertionError("the AP callback did not evaluate or keep its best weights")
    check_metrics("make_ap_eval_callback(every=1) after D1's epoch", cb.history[0])


# ---- --shapes-quality: the port's quality number ------------------------------


def shapes_quality(dev, smi, workdir):
    """Train Shapes at the JAX package's budget (tools/quality_run.py there:
    400 train / 50 val / 50 held-out images, 40 epochs, batch 16, lr 1e-3,
    flip-only augmentation, the AP callback every 5 epochs, score threshold
    0.35) in f32 and in bf16, then evaluate_dataset on the held-out images.
    Prints one JSON line a dtype."""
    for dtype in ("float32", "bfloat16"):
        cfg = type("QualityConfig", (ShapesConfig,), {"COMPUTE_DTYPE": dtype})()
        out = workdir / dtype
        out.mkdir(parents=True)
        train_ds, val_ds, eval_ds = (shapes_dataset(n, SEED + i, cfg)
                                     for i, n in enumerate((400, 50, 50)))
        cb = make_ap_eval_callback(eval_ds, cfg, every=5, batch_size=8, score_threshold=0.35,
                                   history_path=str(out / "ap_history.jsonl"),
                                   best_weights_path=str(out / "best.pt"))
        model = MaskYOLO("training", cfg, model_dir=str(out / "ckpt"), seed=SEED, device=dev)
        t0 = time.perf_counter()
        model.train(train_ds, val_ds, 1e-3, epochs=40, verbose=False,
                    augmentation=augment.Sequential([augment.Fliplr(0.5)], seed=SEED + 7),
                    custom_callbacks=[cb])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        model.save_weights(str(out / "weights.pt"))
        infer = MaskYOLO("inference", cfg, seed=SEED, device=dev)
        infer.load_weights(str(out / "weights.pt"))
        t0 = time.perf_counter()
        result = evaluate_dataset(infer, eval_ds, cfg, batch_size=8, score_threshold=0.35)
        result.pop("per_image")
        result.update(compute_dtype=dtype, train_seconds=round(train_s, 1),
                      eval_seconds=round(time.perf_counter() - t0, 1), epochs=40,
                      train_images=400, best_callback_box_ap50=cb.best, device=smi,
                      ap_trajectory=[{k: e[k] for k in ("epoch", "box_ap50", "mask_ap50")}
                                     for e in cb.history])
        print(json.dumps({"shapes_quality": result}), flush=True)


def kernel_line(name, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
    """One entry of the kernels JSON line; launches: {path: count}."""
    return {"name": name, "route": "cuda", "source": f"mask_yolo_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, **extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="a directory with any of an earlier commit's crop_rois.cu, "
                         "fused_ds_block.cu and fused_mask_branch.cu, timed against the "
                         "current kernels")
    ap.add_argument("--shapes-quality", action="store_true",
                    help="instead of the phases: train Shapes for 40 epochs on 400 images "
                         "in f32 and in bf16 and print held-out box and mask AP")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); TF32 off for cuDNN and matmul")
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    if args.shapes_quality:
        try:
            shapes_quality(dev, smi, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(smi)
        return 0

    # every kernel (and the parent's, when asked) compiles at once, one nvcc
    # each; K1 and K3 while phases 3-6 run
    sources = ("crop_rois", "fused_ds_block", "fused_mask_branch")
    parents = [name for name in sources
               if args.parent_csrc and (args.parent_csrc / f"{name}.cu").exists()]
    pool = ThreadPoolExecutor(max_workers=len(sources) + len(parents))
    pending = {name: pool.submit(timed_build, name) for name in sources}
    pending.update({f"parent {name}": pool.submit(timed_build, name, args.parent_csrc)
                    for name in parents})
    libs = join_builds(pending, ["crop_rois"] + (["parent crop_rois"] if "crop_rois" in parents
                                                 else []))
    new_crop = CropLib(libs["crop_rois"], roi_crop._scratch_bytes, tuple(
        name for name in roi_crop.ENTRY_POINTS if name.startswith("crop_rois_") and
        not name.endswith("scratch_bytes")))
    old_crop = (CropLib(libs["parent crop_rois"], lambda b, h, w, k, pool: 32 * b * k * pool)
                if "crop_rois" in parents else None)

    rng = np.random.default_rng(SEED)
    kernel = phase_kernel(dev, rng, new_crop, old_crop)
    kernel_bwd = phase_train_kernel(dev, rng, new_crop, torch.float32, old_crop)
    kernel_bwd16 = phase_train_kernel(dev, rng, new_crop, torch.bfloat16)

    images = (rng.random((BATCH, *ShapesConfig.IMAGE_SHAPE)) * 255).astype(np.uint8)
    float_counts = {}
    model, cfg = phase_slice("bfloat16", dev, images, float_counts)
    phase_slice("float32", dev, images, float_counts)
    phase_serve(model, cfg, rng, float_counts)
    bf16_ms = phase_throughput(model, cfg, dev, rng, smi)

    libs = join_builds(pending, list(pending))
    pool.shutdown()
    parent = ParentKernels(libs.get("parent fused_ds_block"), libs.get("parent fused_mask_branch"))
    cfg8 = Int8Config()
    model8 = quantized_model(cfg8, dev)
    k1, k3 = phase_kernels_int8(rng, dev, model8, cfg8, parent)
    phase_repairs(dev, rng)
    int8_counts = {}
    phase_int8_slice(model8, model, cfg8, images, int8_counts)
    phase_serve(model8, cfg8, rng, int8_counts, n=16,
                expect=("fused_ds_block", "fused_mask_branch"), tag="serve int8")
    phase_int8_throughput(model8, cfg8, dev, rng, smi, bf16_ms, k1["b128"]["ms"],
                          k3["b128"]["ms"])
    infer_counts = {}
    del model8
    torch.cuda.empty_cache()
    phase_infer_yolo(dev, rng, smi, cfg, cfg8, infer_counts)

    train_counts, train16_counts, data_counts = {}, {}, {}
    try:
        trained, ms32, peak32 = phase_train(dev, smi, train_counts, workdir, TrainConfig())
        shutil.rmtree(workdir)
        _, ms16, peak16 = phase_train(dev, smi, train16_counts, workdir, TrainBf16Config())
        log(f"[train] the step in bf16 on f32 masters {ms16:.3f} ms and {peak16:.0f} MiB at its "
            f"peak, in f32 {ms32:.3f} ms and {peak32:.0f} MiB, on {smi} (recorded, not claimed)")
        shutil.rmtree(workdir)
        workdir.mkdir(parents=True)
        phase_data_and_evaluate(dev, smi, trained, data_counts, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def launches(name):
        return {path: sum(counts.get(name, [])) for path, counts in (
            ("float_detect", float_counts), ("int8_detect", int8_counts),
            ("infer_yolo", infer_counts), ("train", train_counts),
            ("train_bf16", train16_counts), ("data_evaluate", data_counts))}

    b128 = lambda r: {key: r.get(key) for key in (                          # noqa: E731
        "ms", "plain_ms", "bound_ms", "parent_ms", "gemm_core_ms")}

    def crop_line(name, head, rest, counted=None, paths=None):
        """K2's entry: the headline shape's numbers, the others under
        "shapes". counted: the wrapper whose launches the entry reports, on
        `paths` (default: all)."""
        keys = lambda r: {key: v for key, v in r.items() if key not in (   # noqa: E731
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        by_path = {path: n for path, n in launches(counted or name).items()
                   if paths is None or path in paths}
        return kernel_line(name, "crop_rois.cu", "mask_yolo_tpu/ops/pallas_crop.py:92",
                           by_path, head["max_abs_err"], head["ms"], head["plain_ms"],
                           (head["bound_ms"], head["bound_by"]), **keys(head), shapes=rest)

    print(smi)
    print(json.dumps({"kernels": [
        crop_line("crop_rois", kernel.pop("detect"), kernel),
        crop_line("crop_rois_backward", kernel_bwd[0], {"coco416": kernel_bwd[1]},
                  paths=("train", "data_evaluate")),
        # the bf16 gradient's kernel: the same wrapper, counted on the bf16 run
        crop_line("crop_rois_backward_bf16", kernel_bwd16[0], {"coco416": kernel_bwd16[1]},
                  counted="crop_rois_backward", paths=("train_bf16",)),
        kernel_line("fused_ds_block", "fused_ds_block.cu", "mask_yolo_tpu/ops/pallas_ds.py:92",
                    launches("fused_ds_block"), k1["max_abs_err"], k1["ms"], k1["plain_ms"],
                    (k1["bound_ms"], k1["bound_by"]), at="one trunk's 10 calls, B=16",
                    parent_ms=k1["parent_ms"], gemm_core_ms=k1["gemm_core_ms"],
                    b128=b128(k1["b128"])),
        kernel_line("fused_mask_branch", "fused_mask_branch.cu",
                    "mask_yolo_tpu/ops/pallas_mask.py:233", launches("fused_mask_branch"),
                    k3["max_abs_err"], k3["ms"], k3["plain_ms"], (k3["bound_ms"], k3["bound_by"]),
                    at="B=16, K=10, 28x28x256", parent_ms=k3.get("parent_ms"),
                    gemm_core_ms=k3["gemm_core_ms"], b128=b128(k3["b128"]),
                    coco416=b128(k3["416"]))]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
