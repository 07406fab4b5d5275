#!/usr/bin/env python3
"""Run the PyTorch port (`mask_yolo_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs CUDA and nvcc
    python3 chip_smoke.py --shapes-quality [--seeds 0 1 2]
                                   # instead of the phases: tools/quality_run.py
                                   # at the JAX package's budget (400 images, 40
                                   # epochs, flip-only augmentation, AP callback
                                   # every 5 epochs) in f32 and in bf16, box and
                                   # mask AP on 50 held-out images, float and int8
    python3 chip_smoke.py --fpn-quality [--seeds 0 1 2]
                                   # instead of the phases: tools/quality_run.py
                                   # with --backbone resnet50_fpn at the JAX
                                   # package's FPN budget (bf16, 400 images, 40
                                   # epochs, flip-only augmentation), box and
                                   # mask AP on 50 held-out images, float and
                                   # the int8 hybrid
    python3 chip_smoke.py --int8-quality
                                   # instead of the phases: tools/quality_run_coco.py
                                   # (DenseShapes, 80 classes, 416², written as a
                                   # COCO dataset and read back; 300 train, 32 val
                                   # images, 25 epochs, batch 16, lr 1e-3) on
                                   # Coco416Config, then tools/eval_int8.py on 64
                                   # held-out images in f32 weights and four int8
                                   # forms: pt (per tensor), pc (per-channel
                                   # scales), pc_qat (+ 200 finetune steps on 16
                                   # calibration images), pc_qat_mw (mask term
                                   # x4); --train-images N --epochs N set another
                                   # training budget
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
                 yardstick of the tensor cores, not the kernels' function;
                 for K1 the 7x7 (224²) or 13x13 (416²) 1024-wide block's)
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
 Q1. kernel      K3 on graphs calibrated with QUANT_PER_CHANNEL_ACT and
                 bias-corrected (vector activation scales folded into the int8
                 weights, bias_corr in the packed bias) vs its plain version at
                 the 224² shape (B=16, K=10, 28x28x256, nc 4) and at
                 CocoStyleConfig's (B=3, K=48, 52x52x256, nc 81), within phase
                 8's bounds; its time beside the scalar graph's, the bound and
                 torch._int_mm
 Q2. 416² slice  MaskYOLO("inference", Coco416Config) at full width (bf16, 81
                 classes, K=100, MASK_TOP_K 48) on 16 seeded DenseShapes images:
                 detect_batch float (exactly 1 K2 launch) and, after quantize,
                 int8 per tensor (10 K1, 1 K3, 0 K2), per channel + bias
                 correction, and that + 30 finetune steps (0 K1: K1 takes
                 scalar scales only, its pairs run as chained layers; 1 K3, 0
                 K2); each fused result held against the same detector's
                 chained layers; the finetune's loss not above its start, its
                 crop through K2 forward and backward; ms per batch and its
                 split into trunk, mask branch and the rest (recorded)

 F1. FPN        the ResNet-50 + FPN backbone. (a) K2 at the pyramid's shapes
                 (Coco416FpnConfig's: bf16, B=16, K=48 on 52², 26², 13² x 256;
                 TrainFpnConfig's: f32, B=16, K=32 on 28², 14², 7² x 256, with
                 the backward) against the plain twin at phase 3's and T1's
                 bounds, timed as there; multilevel_crop_rois (one K2 call a
                 level) against the plain multi-level crop, levels identical,
                 forward and backward. (b) detect_batch at 416², batch 16,
                 bf16 on DenseShapes scenes: exactly 3 K2 launches; the same
                 trunk outputs through the plain multi-level crop (classes,
                 valid identical, masks >= 99.5 %); ms per batch split into
                 trunk, 3 crops, mask convs and the rest. (e) export_model
                 (symbolic batch) run in a child process at batch 1 and 16:
                 bit-equal to the live detect_batch, 3 crop_rois nodes, 3 K2
                 a call. (c) quantize on 8 images (hybrid: float trunk, int8
                 mask head): QUANT_FUSED_MASK refused; 3 K2 and no K1 or K3;
                 classes equal to (b)'s, scores within 1e-5; ms per batch;
                 on a network of flax's default initializers (the JAX test's
                 setting) the int8 mask probabilities within 0.05 max / 0.02
                 mean of the float head's on (b)'s ROIs (on the He-normal
                 weights of (b), recorded only). (d) two f32 train
                 steps at 224², batch 16: finite loss, 3 K2 forward and 3
                 backward a step, no gradient into the neck; ms per step and
                 peak memory.
 X1. export     MaskYOLO.export_model (symbolic batch) of the bf16 model of
                 phase 4 and the int8 model of phase 9, then
                 ExportedDetector.load in a child process with nothing but
                 the artifact: at batch 1, 3 and 16 its outputs against the
                 live detect_batch (bit-equal, else the parity bounds:
                 classes and valid equal, boxes within 1e-5 of the image,
                 masks on >= 99.9 % of pixels), exactly 1 K2 launch a call
                 (float) or 10 K1 + 1 K3 (int8), the custom ops in the
                 graph; the artifact moved to the CPU against the port's CPU
                 live run at batch 2; ms per batch at 128, artifact beside
                 live (recorded)
 P1. parallel    (a) parallel.distributed.initialize() from the MYOLO_*
                 variables forms a world of one over NCCL, and
                 MaskYOLO.train (2 steps at batch 16) equals the run in one
                 process; (b) two gloo ranks sharing the card (NCCL refuses
                 two ranks on one device), dp 2: the step on 8 + 8 images
                 against one process's step on the 16 (loss rtol 1e-4,
                 params rtol 2e-3 atol 2.1e-3, BN running statistics 1e-5 of
                 each leaf's max; the gradients the update is handed and
                 Adam's first moments by cosine, tree and leaf, GRAD_*, with
                 one process on the batch reordered beside them as the
                 noise floor; one K2 forward and backward a rank),
                 detect_batch(mesh=) in f32 and int8 on 8 + 8 images against
                 one call on 16 (the parity bounds; 10 K1 and 1 K3 a rank);
                 (c) mp 2: the same step with every conv of >= 256 output
                 channels held half per rank before and after; ms per step
                 at 1 and 2 ranks (recorded). Every rank is a child process
                 (`--child`) killed after 420 s.

 C1. entry      the command-line entry points, each a child process run as a
     points      user runs it (`python -m mask_yolo_tpu_torch.<entry>` from the
                 repository root): (a) examples.shapes.train_shapes, 1 epoch on
                 32 images, writes a checkpoint and config.json; (f)
                 tools.gen_anchors --dataset shapes --k 3 beside it, its file
                 equal to the in-process run's; (b) tools.predict on 8 seeded
                 Shapes PNGs with (a)'s checkpoint and config.json
                 (OBJ_THRESHOLD 0), float and --quantize with Int8Config's
                 knobs: its COCO JSON against the in-process detect_batch on
                 the same images and weights (ids equal, scores within 1e-5,
                 boxes 1e-3 px, masks >= 99.9 % of pixels; TF32 at torch's
                 defaults, as the tools run), and predict.run in-process under
                 the launch counts: 1 K2 a float batch, 10 K1 + 1 K3 an int8
                 batch; (c) tools.export_model --verify on (a)'s weights; (d)
                 tools.serve_model from a seeded checkpoint (spread_scores)
                 and from (c)'s artifact, 8 HTTP POST /detect requests each
                 (RLE masks) against the in-process BatchingExecutor, the
                 servers killed after; (e) bench's JSON line with bf16, int8
                 and int8_fused img/s at batch 128; each tool's wall time
                 (both recorded)

 M1. tools      the measurement tools (mask_yolo_tpu_torch/tools), each called
                 in-process through run(config, args) under the launch counts:
                 bench_roofline (default sizes; each reading at most 105 % of
                 the H100 SXM5 data sheet: bf16 989.4, int8 1,978.9, TF32
                 494.7, FP32 66.9 T/s, HBM 3.35 TB/s), profile_stages (batch
                 128), profile_stages_416, profile_infer_yolo,
                 profile_layers_416 and bench_416 (batch 16; bench_416 also
                 per channel and with the FPN backbone's int8 path),
                 bench_export (coco416, batch 16), bench_train (64 images:
                 bf16 at torch's TF32 defaults, f32 with TF32 off, f32 with
                 TF32 on) and ab_infer_yolo_exactness (8 DenseShapes images
                 written as quality_run_coco writes them, seeded weights
                 with spread scores). Held: no tool raises and no row is an
                 error line; every time and rate finite and > 0; each timed
                 callable's output (the stage profilers' full stage,
                 bench_416's paths, the artifact) equal bit for bit to the
                 library entry point's on the same batch, with the same
                 kernel launches a call (1 K2 for the 224^2 detect as in
                 phase 4; fused_both's K1 and K3 as Q2's int8 per tensor).
                 --int8-quality also runs ab_infer_yolo_exactness (k 32 48
                 64, top-n 256) and profile_infer_yolo on its checkpoint.
                 profile_infer_yolo's +nms and full calls are each split by
                 torch.profiler into kernels, the device's busy time and the
                 host gap, the host syncs and the slowest kernels and host
                 ops (recorded)

 G1. graft      mask_yolo_tpu_torch/graft_entry.py (after P1): (a) entry():
     entry       its fn(state, images) at batch 8, bf16, on seeded noise
                 images, eager and as its torch.export program (one
                 crop_rois op), exactly 1 K2 launch a call each, equal to
                 each other and to MaskYOLO.detect_batch on the same weights
                 (bit-equal, else the parity bounds), ms a call (recorded);
                 (b) dryrun_multichip(1): a world of one over NCCL; (c)
                 dryrun_multichip(2, backend="gloo"): two ranks sharing the
                 card, mp 2. Each prints the JAX dryrun's line with a finite
                 loss within rel 1e-4 of the same step in one process on the
                 CPU, step 1 and the detect's batch, and its rank 0 counts
                 1 K2 forward and 1 backward in the step, 1 K2 in the detect

The last lines are a JSON line of F1's results, one of X1's and P1's, one
of C1's, one of M1's, one of G1's, the `nvidia-smi` name/power-limit line, a JSON line of kernels
(times, launches per path, bounds), and {"ok": true, "device": {...}}.
Without a CUDA device the script exits 1 and prints no result.

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
import socket
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
                                 make_ap_eval_callback, native, quant, weights)
from mask_yolo_tpu_torch.data import augment
from mask_yolo_tpu_torch.data.coco import detections_to_coco_results, rle_decode_counts
from mask_yolo_tpu_torch.data.dense_shapes import DenseShapesDataset
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
                                               fpn_levels, interp_matrix,
                                               multilevel_crop_and_resize)
from mask_yolo_tpu_torch.ops.roi_crop import crop_rois, crop_rois_backward, multilevel_crop_rois
from mask_yolo_tpu_torch.parallel import distributed as parallel_distributed
from mask_yolo_tpu_torch.parallel import mesh as parallel_mesh
from mask_yolo_tpu_torch.pipelines import (detect_from_callables, detect_outputs, images_f32,
                                           infer_yolo_from_callables, infer_yolo_outputs,
                                           training_loss)
from mask_yolo_tpu_torch.export import ExportedDetector
from mask_yolo_tpu_torch.serve import BatchingExecutor, rle_to_mask
from mask_yolo_tpu_torch.tools import (eval_int8, gen_anchors, predict, quality_run,
                                       quality_run_coco)
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
COCO_BATCH, COCO_CALIB, COCO_QAT_STEPS = 16, 8, 30   # Q2
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
    """CocoStyleConfig (416², 13x13x5 grid, 81 classes, K=100, MASK_TOP_K 48,
    bf16; int8 depthwise convs by default at this size) with K1 and K3."""
    QUANT_FUSED_DS = True
    QUANT_FUSED_MASK = True


class Int8PcConfig(Int8Config):
    """Int8Config calibrated per channel and bias-corrected."""
    QUANT_PER_CHANNEL_ACT = True
    QUANT_BIAS_CORRECT = True


class Coco416PcConfig(Coco416Config):
    """Coco416Config calibrated per channel and bias-corrected."""
    QUANT_PER_CHANNEL_ACT = True
    QUANT_BIAS_CORRECT = True


class TrainBf16Config(TrainConfig):
    """TrainConfig computing in bf16 on f32 master weights."""
    COMPUTE_DTYPE = "bfloat16"


class Coco416FpnConfig(CocoStyleConfig):
    """F1: CocoStyleConfig (416², 13x13x5 grid, 81 classes, K=100,
    MASK_TOP_K 48, bf16) with the ResNet-50 + FPN backbone: P3, P4, P5 at
    52², 26², 13² x 256."""
    BACKBONE = "resnet50_fpn"


class TrainFpnConfig(TrainConfig):
    """F1: TrainConfig (ShapesConfig, 224², batch 16, f32, K=32) with the
    ResNet-50 + FPN backbone: P3, P4, P5 at 28², 14², 7² x 256."""
    BACKBONE = "resnet50_fpn"


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


def phase_kernel(dev, rng, new, parent=None, shapes=FWD_SHAPES, edges=True):
    """K2 forward at each of `shapes` (FWD_SHAPES): the wrapper vs the plain
    twin, then times through `new` (and `parent`, a CropLib) warm and cold,
    the plain twin's and grid_sample's; with `edges`, the edge shapes too.
    Returns {shape tag: dict of the JSON keys}."""
    results = {}
    for tag, s in shapes.items():
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
    for dtype in (torch.float32, torch.bfloat16) if edges else ():
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
        """The current packed weights of a per-tensor graph in the parent's
        layout: plain GEMM matrices, six scalar activation scales (the
        inverse of each asc row's first entry, so to within a rounding) and
        weight scales without the input scale."""
        old = dict(w)
        old.update({k: v.contiguous() for k, v in unpack_mask_weights(w, cf).items()})
        asc = w["asc"][:, 0].cpu().numpy()
        old["asc"] = np.append(1.0 / asc[:5], asc[6]).astype(np.float32)
        old["wsc"] = (w["wsc"] / torch.as_tensor(old["asc"][:5], device=w["wsc"].device)[:, None]
                      ).contiguous()
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
    k1["416"] = check_k1(rng, dev, DS_416, 4, "416")
    for b, side, key in ((BATCH, 7, None), (THROUGHPUT_BATCH, 7, "b128"), (4, 13, "416")):
        gemm = int_mm_ms(dev, b * side * side, 1024, 1024)
        log(f"[kernel] K1 yardstick: torch._int_mm [{b * side * side}, 1024] x [1024, 1024] "
            f"(the {side}x{side} block's pointwise product, B={b}) {gemm * 1e3:.1f} us")
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


def phase_train_kernel(dev, rng, new, dtype, parent=None, shapes=BWD_SHAPES, edges=True):
    """K2 backward in `dtype` at each of `shapes` (BWD_SHAPES): the wrapper vs
    its plain version and against itself (two runs bit-identical), the index
    kernel's output vs its plain version, then times through `new` (and
    `parent`, a CropLib, f32 only), the plain version's and autograd through
    grid_sample's; with `edges`, the edge shapes and autograd's route to the
    kernel too. Returns a list of dicts of the JSON keys, one a shape."""
    results = []
    name = str(dtype)[6:]
    for s in shapes:
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
    if not edges:
        return results
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


def call_split(fn, reps=5):
    """One warm call of fn() split by torch.profiler (CPU and CUDA
    activities over `reps` back-to-back calls closed by a synchronize):
    the wall ms a call with the profiler off and on, the CUDA kernels a
    call, the device's busy ms (the union of the kernels' intervals) and the
    host gap (profiled wall - busy), the host syncs a call, and the five
    slowest kernels and host ops (by self time) a call."""
    with torch.inference_mode():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_profiled = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    averages = prof.key_averages()
    kernels = sorted((e for e in averages if e.device_time_total > 0),
                     key=lambda e: -e.device_time_total)
    host_ops = sorted((e for e in averages if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)
    syncs = sum(e.count for e in averages if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::_local_scalar_dense"))
    busy_ms = busy / 1e3 / reps
    return {"wall_ms": wall, "wall_ms_profiled": wall_profiled,
            "kernels": len(spans) / reps, "busy_ms": busy_ms,
            "host_gap_ms": wall_profiled - busy_ms, "syncs": syncs / reps,
            "top_kernels": [(e.key[:60], e.device_time_total / 1e3 / reps) for e in kernels[:5]],
            "top_host_ops": [(e.key[:60], e.self_cpu_time_total / 1e3 / reps)
                             for e in host_ops[:5]]}


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
    boxes = run_main_path(lambda: model.infer_yolo(one, display=False), counts, expect=())
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
    boxes8 = model8.infer_yolo(one, display=False)
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


# ---- phases Q1-Q2: the int8 quality tools and the 416² slice ------------------


def phase_k3_vector_scales(rng, dev, k3_scalar):
    """Q1: K3 on per-channel, bias-corrected graphs against its plain version
    at the 224² and the 416² shape, timed beside the scalar graph's call of
    phase 8 (`k3_scalar`). Returns the 224² result with the 416² one under
    "416"."""
    res = {}
    cfg224, cfg416 = Int8PcConfig(), Coco416PcConfig()
    for cfg, b, k, tag, scalar in (
            (cfg224, BATCH, cfg224.DETECTION_MAX_INSTANCES, "224 per-channel", k3_scalar),
            (cfg416, 3, cfg416.MASK_TOP_K, "416 per-channel", k3_scalar["416"])):
        model = quantized_model(cfg, dev)
        layers = model._qdet.graph["mask"]
        if not all(isinstance(l.a_scale, np.ndarray) for l in layers) or not all(
                l.act_folded and l.bias_corr is not None for l in layers[:5]):
            raise AssertionError("the graph is not per-channel and bias-corrected")
        r = check_k3(rng, dev, model._qdet, cfg, b, k, tag, True)
        log(f"[kernel] K3 {tag} B={b} K={k}: {r['ms']:.3f} ms on vector scales beside "
            f"{scalar['ms']:.3f} ms on the scalar graph (phase 8, the same kernel code), bound "
            f"{r['bound_ms']:.4f} ms, torch._int_mm {r['gemm_core_ms']:.3f} ms")
        res[tag[:3]] = r
        del model
        torch.cuda.empty_cache()
    out = res["224"]
    out["416"] = res["416"]
    out["max_abs_err"] = max(out["max_abs_err"], out["416"]["max_abs_err"])
    return out


def dense_images(count, seed, size):
    """`count` seeded DenseShapes scenes (80 classes, 24-48 instances) as one
    uint8 array."""
    ds = DenseShapesDataset()
    ds.load_dense(count, size, size, seed=seed, num_classes=80)
    ds.prepare()
    return np.stack([ds.load_image(i) for i in ds.image_ids])


def check_outputs(out, cfg, batch, what):
    """A 416² detect's outputs: shapes and dtypes, finite, at least one valid
    detection an image on average, classes in range."""
    k, (h, w) = cfg.DETECTION_MAX_INSTANCES, cfg.IMAGE_SHAPE[:2]
    if tuple(out["masks"].shape) != (batch, k, h, w) or out["masks"].dtype != torch.bool \
            or tuple(out["boxes"].shape) != (batch, k, 4):
        raise AssertionError(f"{what}: masks {tuple(out['masks'].shape)} {out['masks'].dtype}")
    if not (torch.isfinite(out["scores"]).all() and torch.isfinite(out["boxes"]).all()):
        raise AssertionError(f"{what}: non-finite scores or boxes")
    if int(out["valid"].sum()) < batch or int(out["classes"].max()) >= cfg.NUM_CLASSES:
        raise AssertionError(f"{what}: too few detections or a class out of range")


def coco_split(tag, model, det, images, cfg, smi, total_ms):
    """The split of one detect_batch into trunk, mask branch and the rest
    (decode, NMS, top-K, select, paste), each timed alone on the batch's own
    ROIs."""
    with torch.inference_mode():
        x = images_f32(images)
        out = model.detect_batch(images)
        kp = cfg.MASK_TOP_K
        h, w = cfg.IMAGE_SHAPE[:2]
        rois = (out["boxes"][:, :kp] / torch.tensor([w, h, w, h], device=x.device)).contiguous()
        classes = out["classes"][:, :kp].contiguous()
        if det is None:
            grid, fmap = model.net.trunk(x)
            trunk = cuda_ms(lambda: model.net.trunk(x), 5, 2)
            branch = cuda_ms(lambda: model.net.mask_branch(rois, fmap), 5, 2)
            name = "mask convs + K2"
        else:
            fmap = det.trunk(x)[1]
            trunk = cuda_ms(lambda: det.trunk(x), 5, 2)
            branch = cuda_ms(lambda: det.fused_mask(rois, fmap, classes), 5, 2)
            name = "K3"
    b = images.shape[0]
    log(f"[coco416] {tag}: detect_batch B={b} {total_ms:.3f} ms/batch ({b * 1e3 / total_ms:.1f} "
        f"img/s) = trunk {trunk:.3f} + {name} {branch:.3f} ({b * kp} ROIs) + the rest "
        f"~{total_ms - trunk - branch:.3f} ms on {smi} (recorded, not claimed)")


def phase_coco416(dev, smi, counts):
    """Q2: detect_batch at CocoStyleConfig's full width on DenseShapes images,
    float and in three int8 forms, with launch counts, the fused result
    against the chained layers, and ms per batch."""
    cfg = Coco416Config()
    h, w = cfg.IMAGE_SHAPE[:2]
    t0 = time.perf_counter()
    images_np = dense_images(COCO_BATCH + COCO_CALIB, SEED + 5, h)
    images = torch.as_tensor(images_np[:COCO_BATCH], device=dev)
    calib = images_np[COCO_BATCH:]
    log(f"[coco416] {len(images_np)} DenseShapes scenes at {h}x{w} (80 classes) generated in "
        f"{time.perf_counter() - t0:.1f} s")

    model = MaskYOLO("inference", cfg, seed=SEED, device=dev)
    out = run_main_path(lambda: model.detect_batch(images), counts)
    check_outputs(out, cfg, COCO_BATCH, "bf16")
    launched = {name: counts[name][-1] for name in KERNELS}
    log(f"[coco416] bf16 detect_batch B={COCO_BATCH}: {int(out['valid'].sum())} valid detections, "
        f"{int(out['masks'].sum())} mask pixels; launches {launched}")
    if launched != {"crop_rois": 1, "crop_rois_backward": 0, "fused_ds_block": 0,
                    "fused_mask_branch": 0}:
        raise AssertionError(f"the float 416² batch launched {launched}, expected one K2")
    ms = cuda_ms(lambda: model.detect_batch(images), 5, 2)
    coco_split("bf16", model, None, images, cfg, smi, ms)
    del model

    results = {}
    forms = (("per tensor", Coco416Config(), 0, K1_LAUNCHES),
             ("per channel + bias correction", Coco416PcConfig(), 0, 0),
             (f"per channel + bias correction + {COCO_QAT_STEPS} finetune steps",
              Coco416PcConfig(), COCO_QAT_STEPS, 0))
    for tag, qcfg, qat_steps, want_k1 in forms:
        model = MaskYOLO("inference", qcfg, seed=SEED, device=dev)
        for kern in KERNELS.values():
            kern.launches = 0
        t0 = time.perf_counter()
        det = model.quantize(calib, finetune_steps=qat_steps)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        if qat_steps:
            r = det.finetune_result
            log(f"[coco416] finetune on {COCO_CALIB} images: {qat_steps} steps in {quant_s:.1f} s "
                f"with calibration ({quant_s / qat_steps:.3f} s a step at most), loss "
                f"{r['loss_initial']:.6f} -> {r['loss_final']:.6f}; K2 forward "
                f"{crop_rois.launches}, backward {crop_rois_backward.launches} launches")
            if not r["loss_final"] <= r["loss_initial"] \
                    or crop_rois_backward.launches != qat_steps:
                raise AssertionError("the finetune's loss rose or its crop missed K2's backward")
        out = run_main_path(lambda: model.detect_batch(images), counts,
                            ("fused_mask_branch",))
        check_outputs(out, qcfg, COCO_BATCH, tag)
        launched = (counts["fused_ds_block"][-1], counts["fused_mask_branch"][-1],
                    counts["crop_rois"][-1])
        if launched != (want_k1, K3_LAUNCHES, 0):
            raise AssertionError(f"{tag}: launches K1 {launched[0]}, K3 {launched[1]}, K2 "
                                 f"{launched[2]}; expected {want_k1}, {K3_LAUNCHES}, 0")
        with torch.inference_mode():
            chained = det.detect_outputs(images, fused_mask=False, fused_ds=False)
            for key in ("boxes", "classes", "scores", "valid"):
                if not torch.equal(out[key], chained[key]):
                    raise AssertionError(f"{tag}: {key} differ between the fused and the "
                                         f"chained int8 path")
            agree = (out["masks"] == chained["masks"]).float().mean().item()
            # the branch's sigmoid masks on this batch's own ROIs, fused and chained
            kp = qcfg.MASK_TOP_K
            fmap = det.trunk(images_f32(images))[1]
            rois = (out["boxes"][:, :kp] / torch.tensor([w, h, w, h], device=dev)).contiguous()
            classes = out["classes"][:, :kp].contiguous()
            fused = det.fused_mask(rois, fmap, classes)
            full = det.mask_branch(rois, fmap)
            sel = torch.gather(full, -1, classes.long()[:, :, None, None, None].expand(
                -1, -1, *full.shape[2:4], 1))[..., 0]
        worst = check_mask_agreement(fused, sel, f"coco416 int8 {tag}: K3 vs the chained branch")
        log(f"[coco416] int8 {tag}: quantize in {quant_s:.1f} s; {int(out['valid'].sum())} valid "
            f"detections; launches K1 {launched[0]}, K3 {launched[1]}, K2 {launched[2]}; fused "
            f"vs chained: boxes, classes, scores, valid identical, pasted masks agree on "
            f"{agree:.6f} of pixels (limit {MASK_AGREE})")
        if agree < MASK_AGREE:
            raise AssertionError(f"{tag}: fused and chained int8 masks disagree")
        ms = cuda_ms(lambda: model.detect_batch(images), 5, 2)
        coco_split(f"int8 {tag}", model, det, images, qcfg, smi, ms)
        results[tag] = {"ms": ms, "max_abs_err": worst}
        del model, det
        torch.cuda.empty_cache()
    return results


# ---- --int8-quality: the int8 tools' quality on the 81-class point ------------


def int8_quality(dev, smi, workdir, train_images=300, epochs=25):
    """tools/quality_run_coco.py at its default budget (300 train / 32 val
    images, 25 epochs, batch 16, lr 1e-3, score threshold 0.35) on
    Coco416Config (the port's main int8 path: K1 where the scales are
    scalar, K3), f32 evaluation only, then tools/eval_int8.py on its weights
    and 64 held-out images: f32 and the int8 variants pt, pc, pc_qat,
    pc_qat_mw (16 calibration images, 200 finetune steps at lr 1e-5).
    Prints one JSON line."""
    argv = ["--train-images", str(train_images), "--val-images", "32", "--eval-images", "64",
            "--epochs", str(epochs), "--skip-int8", "--num-overlays", "0",
            "--out", str(workdir), "--device", str(dev)]
    args = quality_run_coco.parser().parse_args(argv)
    trained = quality_run_coco.run(quality_run_coco.run_config(args, Coco416Config), args)
    args = eval_int8.parser().parse_args(
        ["--weights", str(workdir / "weights"), "--data", str(workdir / "coco_eval"),
         "--variants", "f32", "pt", "pc", "pc_qat", "pc_qat_mw", "--device", str(dev)])
    for kern in KERNELS.values():
        kern.launches = 0
    result = eval_int8.run(eval_int8.run_config(args, Coco416Config), args)
    print(json.dumps({"int8_quality": {
        "device": smi, "train_seconds": trained["train_seconds"], "epochs": epochs,
        "train_images": train_images, "f32_at_train_time": {
            k: trained[k] for k in ("box_ap50", "mask_ap50", "box_map", "mask_map")},
        "launches": {n: kern.launches for n, kern in KERNELS.items()}, **result}}), flush=True)
    # the post-training studies of tools/r5_studies.sh on the trained checkpoint
    from mask_yolo_tpu_torch.tools import ab_infer_yolo_exactness, profile_infer_yolo

    weights_path = str(workdir / "weights")
    args = ab_infer_yolo_exactness.parser().parse_args(
        ["--weights", weights_path, "--data", str(workdir / "coco_eval"), "--k", "32", "48",
         "64", "--top-n", "256", "--device", str(dev)])
    ab_infer_yolo_exactness.run(ab_infer_yolo_exactness.run_config(args, Coco416Config), args)
    args = profile_infer_yolo.parser().parse_args(["--batch", "128", "--weights", weights_path,
                                                   "--device", str(dev)])
    rows = profile_infer_yolo.run(profile_infer_yolo.run_config(args), args)
    if any("error" in r for r in rows):
        raise AssertionError(f"profile_infer_yolo on the trained checkpoint: {rows}")


# ---- --shapes-quality: the port's quality number ------------------------------


def shapes_quality(dev, smi, workdir, seeds=(0,)):
    """tools/quality_run.py at the JAX package's recorded budget (400 train /
    50 val / 50 held-out images, 40 epochs, batch 16, lr 1e-3, flip-only
    augmentation, the AP callback every 5 epochs, score threshold 0.35) in
    f32 and in bf16, at each seed of `seeds` (--seed: the datasets, the
    initial weights and the flip draws), without overlays (no matplotlib on
    the card's machine). Prints one JSON line a seed and dtype."""
    for seed in seeds:
        for dtype in ("float32", "bfloat16"):
            args = quality_run.parser().parse_args(
                ["--augment-flip-only", "--eval-every", "5", "--num-overlays", "0",
                 "--compute-dtype", dtype, "--seed", str(seed),
                 "--out", str(workdir / f"{dtype}_{seed}"), "--device", str(dev)])
            result = quality_run.run(quality_run.run_config(args), args)
            print(json.dumps({"shapes_quality": {"compute_dtype": dtype, "seed": seed,
                                                 "device": smi, **result}}), flush=True)


def fpn_quality(dev, smi, workdir, seeds=(0,)):
    """tools/quality_run.py at the budget of the JAX package's ResNet-50 +
    FPN figure (asset/shapes_fpn_metrics_r3.json: 400 train / 50 val / 50
    held-out images, 40 epochs, batch 16, lr 1e-3, bf16, flip-only
    augmentation, score threshold 0.35), with no AP callback (that run's
    metrics carry no AP trajectory) and no overlays, at each seed of
    `seeds`. Prints one JSON line a seed: the float AP (pooled and per
    image, box and mask, recall@50) and the int8 hybrid's on the same
    weights."""
    for seed in seeds:
        args = quality_run.parser().parse_args(
            ["--backbone", "resnet50_fpn", "--compute-dtype", "bfloat16", "--augment-flip-only",
             "--num-overlays", "0", "--seed", str(seed), "--out", str(workdir / f"fpn_{seed}"),
             "--device", str(dev)])
        result = quality_run.run(quality_run.run_config(args), args)
        print(json.dumps({"fpn_quality": {"seed": seed, "device": smi, **result}}), flush=True)


# ---- phases X1 and P1: the export artifact and the parallel paths -----------

EXPORT_BATCHES = (1, 3, 16)        # X1: the artifact's batches against the live path
EXPORT_CPU_BATCH = 2               # X1: the CUDA artifact moved to the CPU
EXPORT_LAUNCHES = {"float": {"crop_rois": 1, "crop_rois_backward": 0, "fused_ds_block": 0,
                             "fused_mask_branch": 0},
                   "int8": {"crop_rois": 0, "crop_rois_backward": 0,
                            "fused_ds_block": K1_LAUNCHES, "fused_mask_branch": K3_LAUNCHES}}
# the port's parity bounds (tests/test_torch_export.py): classes and valid
# equal, boxes within this of the image size, masks equal on this share
PARITY_BOX, PARITY_MASK = 1e-5, 0.999
P1_BATCH, P1_LR = 16, 1e-3         # P1: the global batch and the step's learning rate
# the step on the mesh against one process (tests/test_multichip.py's
# tolerances; BatchNorm's running statistics relative to each leaf's max)
STEP_LOSS_RTOL, STEP_RTOL, STEP_ATOL, BN_REL = 1e-4, 2e-3, 2.1e-3, 1e-5
# One Adam step moves every weight by about lr whatever its gradient, so the
# parameters alone cannot tell a wrong gradient: the gradients the update is
# handed, and Adam's first moment after it ((1 - b1) times the clipped
# gradient), are held to one process's. The whole tree by its cosine and by
# the norm of its difference against its own norm (which a wrong scale, as
# of a clip norm, moves and the cosine does not), and each leaf by the norm
# of its difference against the leaf's norm, or a thousandth of the tree's
# where the leaf is smaller: the biases ahead of a train-mode BatchNorm have
# a gradient of zero but for rounding. One process's step on the same batch
# in another order, the noise floor beside them, reads cosine 0.99998, 0.54 %
# and 0.92 % (NVIDIA H100 80GB HBM3, 700 W)
GRAD_COS, GRAD_REL, GRAD_LEAF, GRAD_FLOOR = 0.9999, 0.02, 0.05, 1e-3
CHILD_TIMEOUT_S = 420              # a child (or rank) that runs longer is killed


def detect_parity(got, want, cfg):
    """(bit-equal?, {measured}) of two detect dicts (numpy); raises beyond
    the parity bounds."""
    exact = all(np.array_equal(got[k], want[k]) for k in want)
    h, w = cfg.IMAGE_SHAPE[:2]
    scale = np.array([w, h, w, h], np.float32)
    box = float(np.abs(got["boxes"] / scale - want["boxes"] / scale).max())
    agree = float((got["masks"] == want["masks"]).mean())
    same = all(np.array_equal(got[k], want[k]) for k in ("classes", "valid"))
    if not (same and box <= PARITY_BOX and agree >= PARITY_MASK):
        raise AssertionError(f"outside the parity bounds: classes/valid equal {same}, boxes "
                             f"{box:.3g} (limit {PARITY_BOX}), masks agree {agree:.6f} "
                             f"(limit {PARITY_MASK})")
    return exact, {"max_box_err": box, "mask_agree": agree}


def host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_children(kind, n, workdir, **env):
    """Run `python3 chip_smoke.py --child <kind> <workdir>` as n ranks (the
    MYOLO_* triplet set); each must exit 0 within CHILD_TIMEOUT_S, or it is
    killed and the phase fails. Returns each rank's JSON result."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(n):
        log_file = open(workdir / f"{kind}{rank}.log", "w")
        child_env = dict(os.environ, MYOLO_COORDINATOR=f"localhost:{port}",
                         MYOLO_NUM_PROCESSES=str(n), MYOLO_PROCESS_ID=str(rank), **env)
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", kind, str(workdir)],
            env=child_env, stdout=log_file, stderr=subprocess.STDOUT), log_file))
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                if proc.wait(timeout=CHILD_TIMEOUT_S) != 0:
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
    finally:
        for proc, log_file in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    for rank in range(n):
        for line in (workdir / f"{kind}{rank}.log").read_text().splitlines():
            if line.startswith("["):
                log(f"  rank {rank}: {line}")
    if failed:
        tails = "\n".join((workdir / f"{kind}{r}.log").read_text()[-4000:] for r in failed)
        raise AssertionError(f"{kind}: ranks {failed} failed or timed out:\n{tails}")
    return [json.loads((workdir / f"{kind}{r}.json").read_text()) for r in range(n)]


def phase_export(dev, smi, model, model8, workdir):
    """X1: export_model (symbolic batch) of the bf16 and the int8 detector,
    then ExportedDetector.load in a child process: at batch 1, 3 and 16 its
    outputs against the live detect_batch, exactly 1 K2 launch (float) or
    10 K1 + 1 K3 (int8) a call; the artifact moved to the CPU against the
    port's CPU live run at batch 2; ms per batch at 128, artifact beside
    live. Returns ({tag: result}, {path: {kernel: launches of each call}})."""
    rng = np.random.default_rng(SEED + 8)
    images = (rng.random((THROUGHPUT_BATCH, *ShapesConfig.IMAGE_SHAPE)) * 255).astype(np.uint8)
    np.save(workdir / "images.npy", images)
    x = torch.as_tensor(images, device=dev)
    live, result = {}, {}
    for tag, m in (("float", model), ("int8", model8)):
        t0 = time.perf_counter()
        header = m.export_model(workdir / f"{tag}.pt2", platforms=["cuda", "cpu"])
        seconds = time.perf_counter() - t0
        live[tag] = {b: host(m.detect_batch(images[:b])) for b in EXPORT_BATCHES}
        cpu = MaskYOLO("inference", m.config, seed=SEED, device="cpu")
        if tag == "int8":   # the card's int8 graph (a CPU calibration gives other scales)
            cpu._qdet = quant.QuantizedDetector(m._qdet.graph, m.config, device="cpu")
        live[tag]["cpu"] = host(cpu.detect_batch(images[:EXPORT_CPU_BATCH]))
        result[tag] = {"export_s": seconds, "live_ms": cuda_ms(lambda: m.detect_batch(x),
                                                               iters=10, warmup=3),
                       "bytes": (workdir / f"{tag}.pt2").stat().st_size,
                       "batch_size": header["batch_size"]}
    child = run_children("export", 1, workdir)[0]
    outputs = np.load(workdir / "export_out.npz")
    counts = {}
    for tag, cfg in (("float", model.config), ("int8", model8.config)):
        r = result[tag] | child[tag]
        counts[f"export_{tag}"] = {name: [c[name] for c in r["per_call"]] for name in KERNELS}
        if any(c != EXPORT_LAUNCHES[tag] for c in r["per_call"]):
            raise AssertionError(f"{tag} artifact launches {r['per_call']}, expected "
                                 f"{EXPORT_LAUNCHES[tag]} a call")
        if r["graph_ops"] != {k: v for k, v in EXPORT_LAUNCHES[tag].items() if v}:
            raise AssertionError(f"{tag} artifact graph holds {r['graph_ops']}")
        verdicts = []
        for b in EXPORT_BATCHES:
            got = {k[len(f"{tag}.{b}."):]: outputs[k] for k in outputs.files
                   if k.startswith(f"{tag}.{b}.")}
            exact, measured = detect_parity(got, live[tag][b], cfg)
            verdicts.append(f"B={b} {'bit-equal' if exact else measured}")
        got = {k[len(f"{tag}.cpu."):]: outputs[k] for k in outputs.files
               if k.startswith(f"{tag}.cpu.")}
        exact, measured = detect_parity(got, live[tag]["cpu"], cfg)
        verdicts.append(f"moved to the CPU, B={EXPORT_CPU_BATCH}, against the CPU live run "
                        f"{'bit-equal' if exact else measured}")
        log(f"[export] {tag}: export_model {r['export_s']:.1f} s, {r['bytes'] / 2**20:.1f} MiB; "
            f"child load {r['load_s']:.1f} s, graph custom ops {r['graph_ops']}; launches a "
            f"call {r['per_call'][0]}; " + "; ".join(verdicts) + f"; B={THROUGHPUT_BATCH}: "
            f"artifact {r['ms']:.3f} ms/batch, live {r['live_ms']:.3f} ms/batch on {smi} "
            f"(recorded, not claimed)")
        result[tag] = r
    return result, counts


def child_export(dev, workdir):
    """X1's child: loads the artifacts with nothing but the export module and
    runs them."""
    from mask_yolo_tpu_torch.export import ExportedDetector, custom_op_counts

    images = np.load(workdir / "images.npy")
    x = torch.as_tensor(images, device=dev)
    result, outputs = {}, {}
    for tag in ("float", "int8"):
        t0 = time.perf_counter()
        det = ExportedDetector.load(workdir / f"{tag}.pt2")
        load_s = time.perf_counter() - t0
        per_call = []
        for b in EXPORT_BATCHES:
            for k in KERNELS.values():
                k.launches = 0
            out = det.detect_batch(images[:b])
            torch.cuda.synchronize()
            per_call.append({name: k.launches for name, k in KERNELS.items()})
            outputs.update({f"{tag}.{b}.{k}": v for k, v in host(out).items()})
        ms = cuda_ms(lambda: det.detect_batch(x), iters=10, warmup=3)
        cpu = ExportedDetector.load(workdir / f"{tag}.pt2", device="cpu")
        outputs.update({f"{tag}.cpu.{k}": v for k, v in host(
            cpu.detect_batch(images[:EXPORT_CPU_BATCH])).items()})
        result[tag] = {"load_s": load_s, "graph_ops": custom_op_counts(det.program),
                       "per_call": per_call, "ms": ms}
    np.savez(workdir / "export_out.npz", **outputs)
    return result


def p1_batch(cfg, dev):
    """The global batch of P1: the targets of the first 16 images of a seeded
    Shapes set, on seeded noise images (as tests/test_torch_parallel.py):
    the flat colours of Shapes images leave BatchNorm near-zero variances,
    which make the TRAIN_BN gradient ill-conditioned, so that two f32
    summation orders of one step differ far more than on noise."""
    one = type("P1Batch", (type(cfg),), {"BATCH_SIZE": P1_BATCH})()
    gen = BatchGenerator(preload_dataset(shapes_dataset(P1_BATCH, SEED + 2, one), one), one,
                         shuffle=False)
    batch = dict(gen[0])
    batch["image"] = np.random.default_rng(SEED + 3).random(
        batch["image"].shape, dtype=np.float32)
    return to_device(batch, dev)


def compare_step(loss, params, stats, want_loss, want_params, want_stats):
    """The step on the mesh against one process's: {measured}; raises beyond
    the tolerances."""
    loss_err = abs(loss - want_loss) / abs(want_loss)
    param_err = max(float(((params[k] - v).abs() - STEP_RTOL * v.abs()).max())
                    for k, v in want_params.items())
    param_diff = max(float((params[k] - v).abs().max()) for k, v in want_params.items())
    bn_err = max(float((stats[k] - v).abs().max() / v.abs().max().clamp(min=1e-12))
                 for k, v in want_stats.items())
    if loss_err > STEP_LOSS_RTOL or param_err > STEP_ATOL or bn_err > BN_REL:
        raise AssertionError(f"the step differs from one process's: loss rel {loss_err:.3g}, "
                             f"params beyond rtol by {param_err:.3g}, BN stats rel {bn_err:.3g}")
    return {"loss_rel_err": loss_err, "param_excess": param_err, "max_param_diff": param_diff,
            "bn_rel_err": bn_err}


def record_first_update(tx):
    """tx, keeping the gradients its next update is handed in tx.seen; after
    that update it is itself again (the timed steps copy nothing)."""
    apply = tx.apply

    def record(params, grads, opt_state):
        tx.seen = {k: g.detach().clone() for k, g in grads.items() if g is not None}
        del tx.apply
        apply(params, grads, opt_state)

    tx.apply = record
    return tx


def compare_trees(what, got, want):
    """{cos, rel, worst_leaf, worst_key} of two {key: tensor} trees; raises
    beyond GRAD_COS / GRAD_REL / GRAD_LEAF or if their keys differ."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ: {sorted(set(got) ^ set(want))[:5]}")
    keys = sorted(want)
    a = torch.cat([got[k].double().flatten() for k in keys])
    b = torch.cat([want[k].double().flatten() for k in keys])
    cos = float(a @ b / (a.norm() * b.norm()))
    rel = float((a - b).norm() / b.norm())
    floor = GRAD_FLOOR * float(b.norm())
    worst, key = max((float((got[k].double() - want[k].double()).norm())
                      / max(float(want[k].double().norm()), floor), k) for k in keys)
    if not (cos >= GRAD_COS and rel <= GRAD_REL and worst <= GRAD_LEAF):
        raise AssertionError(f"{what} differ from one process's: cosine {cos:.7f} (limit "
                             f"{GRAD_COS}), tree {rel:.3g} (limit {GRAD_REL}), worst leaf "
                             f"{key} {worst:.3g} (limit {GRAD_LEAF})")
    return {"cos": cos, "rel": rel, "worst_leaf": worst, "worst_key": key}


def wide_shards(net):
    """{key: shape} of the convs with >= 256 output channels (whole or held)."""
    return {k: list(p.shape) for k, p in net.named_parameters()
            if p.dim() == 4 and p.shape[1 if "deconv" in k else 0] >= 128}


def step_ms(step, state, batch, n=5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def child_nccl(dev, workdir):
    """P1(a): MaskYOLO.train (2 steps at batch 16 + 1 validation step) in one
    process, then the same in a world of one over NCCL. Both runs take
    deterministic algorithms (cuDNN's, and scatter-add's for the gathers'
    gradients; CUBLAS_WORKSPACE_CONFIG is set by the parent), so that two
    steps of Adam do not amplify atomics' summation order."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = TrainConfig()
    train_ds, val_ds = shapes_dataset(2 * P1_BATCH, SEED, cfg), shapes_dataset(P1_BATCH,
                                                                                 SEED + 1, cfg)
    runs = []
    for joined in (False, True):
        if joined:
            rank, world = parallel_distributed.initialize(device=dev)
            backend = "nccl" if dev.type == "cuda" else "gloo"
            if (rank, world, torch.distributed.get_backend()) != (0, 1, backend):
                raise AssertionError(f"expected a world of one over {backend}, got rank {rank} of "
                                     f"{world} over {torch.distributed.get_backend()}")
        model = MaskYOLO("training", cfg, model_dir=str(workdir / f"nccl{int(joined)}"),
                         seed=SEED, device=dev)
        for k in KERNELS.values():
            k.launches = 0
        model.train(train_ds, val_ds, P1_LR, epochs=1, verbose=False)
        torch.cuda.synchronize()
        history = json.loads((workdir / f"nccl{int(joined)}" / "history.jsonl").read_text())
        runs.append((history["loss"], {k: v.detach().clone() for k, v in
                                       model.net.named_parameters()},
                     {k: v.clone() for k, v in model.net.named_buffers()
                      if k.endswith(("running_mean", "running_var"))},
                     {name: k.launches for name, k in KERNELS.items()}))
    (loss0, p0, s0, _), (loss1, p1, s1, launches) = runs
    want = (cfg.STEPS_PER_EPOCH + cfg.VALIDATION_STEPS, cfg.STEPS_PER_EPOCH)
    if (launches["crop_rois"], launches["crop_rois_backward"]) != want:
        raise AssertionError(f"K2 launches {launches}, expected forward/backward {want}")
    measured = compare_step(loss1, p1, s1, loss0, p0, s0)
    measured["bit_equal"] = all(torch.equal(p1[k], p0[k]) for k in p0) and all(
        torch.equal(s1[k], s0[k]) for k in s0)
    print(f"[nccl] world of one over NCCL: MaskYOLO.train 2 steps at batch {P1_BATCH}, loss "
          f"{loss1:.6f} vs {loss0:.6f} in one process; {measured}; launches {launches}",
          flush=True)
    parallel_distributed.shutdown()
    return {"launches": launches, **measured}


def child_mesh(kind, dev, workdir):
    """P1(b) and (c): two gloo ranks sharing the card. The step on the mesh
    (dp 2 × mp 1, or dp 1 × mp 2) against one process's step on the same 16
    images; (b) also detect_batch(mesh=) and the int8 detect on 8 + 8
    images against one call on 16."""
    rank, world = parallel_distributed.initialize(device=dev, backend="gloo")
    dp, mp = (2, 1) if kind == "dp" else (1, 2)
    cfg = type("P1Mesh", (TrainConfig,), {"DATA_PARALLEL": dp, "MODEL_PARALLEL": mp,
                                       "BATCH_SIZE": P1_BATCH // dp})()
    batch = p1_batch(cfg, dev)
    mesh = parallel_mesh.build_mesh(cfg)
    rows = parallel_mesh.batch_slice(P1_BATCH, mesh)
    model = MaskYOLO("training", cfg, seed=SEED, device=dev)
    whole = wide_shards(model.net)
    shardings = parallel_mesh.place_network(model.net, mesh)
    before = wide_shards(model.net)
    tx = record_first_update(
        train_state.make_optimizer(P1_LR, cfg, dict(model.net.named_parameters())))
    tx.shard(shardings, mesh.model_group)
    step = trainer.make_train_step(cfg, tx, "training", mesh=mesh)
    state = train_state.create_train_state(model.net, tx)
    local = {k: v[rows] for k, v in batch.items()}
    for k in KERNELS.values():
        k.launches = 0
    state, metrics = step(state, local)
    torch.cuda.synchronize()
    train_launches = {name: k.launches for name, k in KERNELS.items()}
    if (train_launches["crop_rois"], train_launches["crop_rois_backward"]) != (1, 1):
        raise AssertionError(f"rank {rank}: K2 launches {train_launches} in one step")
    after = wide_shards(model.net)
    for key, dim in shardings.items():
        if key in whole and dim is not None:
            want = list(whole[key])
            want[dim] //= mp
            if before[key] != want or after[key] != want:
                raise AssertionError(f"{key}: held {before[key]} / {after[key]}, not {want}")
    held = sum(1 for key, dim in shardings.items() if key in whole and dim is not None)
    if mp > 1 and held != sum(1 for k, s in whole.items() if s[1 if "deconv" in k else 0] >= 256):
        raise AssertionError("a conv with >= 256 output channels is not sharded")
    # copies: the timed steps below move the live tensors on
    params = {k: v.clone() for k, v in parallel_mesh.gather_tree(
        {k: v.detach() for k, v in state.params.items()}, shardings, mesh).items()}
    stats = {k: v.clone() for k, v in parallel_mesh.gather_tree(
        state.batch_stats, shardings, mesh).items()}
    grads = parallel_mesh.gather_tree(tx.seen, shardings, mesh)
    mu = {k: v.clone() for k, v in parallel_mesh.gather_tree(
        state.opt_state["mu"], shardings, mesh).items()}
    loss = float(metrics["loss"])
    ms = step_ms(step, state, local)
    result = {"rank": rank, "launches": {"train": train_launches}, "ms": ms,
              "sharded_convs": held}
    if rank == 0:
        one = MaskYOLO("training", TrainConfig(), seed=SEED, device=dev)
        tx1 = record_first_update(train_state.make_optimizer(
            P1_LR, TrainConfig(), dict(one.net.named_parameters())))
        step1 = trainer.make_train_step(TrainConfig(), tx1, "training")
        state1 = train_state.create_train_state(one.net, tx1)
        state1, metrics1 = step1(state1, batch)
        result.update(compare_step(loss, params, stats, float(metrics1["loss"]),
                                   {k: v.detach() for k, v in state1.params.items()},
                                   state1.batch_stats))
        result["grads"] = compare_trees("the gradients", grads, tx1.seen)
        result["adam_mu"] = compare_trees("Adam's first moments", mu, state1.opt_state["mu"])
        # the noise floor: one process's step on the batch in another order
        again = MaskYOLO("training", TrainConfig(), seed=SEED, device=dev)
        tx2 = record_first_update(train_state.make_optimizer(
            P1_LR, TrainConfig(), dict(again.net.named_parameters())))
        order = torch.randperm(P1_BATCH, generator=torch.Generator().manual_seed(SEED))
        trainer.make_train_step(TrainConfig(), tx2, "training")(
            train_state.create_train_state(again.net, tx2),
            {k: v[order.to(v.device)] for k, v in batch.items()})
        result["grads_reordered"] = compare_trees("the reordered batch's gradients",
                                                  tx2.seen, tx1.seen)
        del again, tx2
        norm = float(torch.stack([g.norm() for g in tx1.seen.values()]).norm())
        result["grad_norm"] = {"one_process": norm, "clip": tx1.clip}
        result["one_process_ms"] = step_ms(step1, state1, batch)
        print(f"[{kind}] step on the {dp}x{mp} mesh (gloo, 2 ranks on one card), batch "
              f"{P1_BATCH}: loss {loss:.6f} vs {float(metrics1['loss']):.6f} in one process; "
              f"{ {k: result[k] for k in ('loss_rel_err', 'param_excess', 'bn_rel_err')} }; "
              f"gradients {result['grads']}, Adam mu {result['adam_mu']} (global norm "
              f"{norm:.4g}, clip {tx1.clip}; one process on the batch reordered: "
              f"{result['grads_reordered']}); {held} convs held O/{mp} before and after",
              flush=True)
    if kind == "dp":
        rng = np.random.default_rng(SEED + 9)
        images = (rng.random((P1_BATCH, *ShapesConfig.IMAGE_SHAPE)) * 255).astype(np.uint8)
        f32 = MaskYOLO("inference", ShapesConfig(), seed=SEED, device=dev)
        m8 = MaskYOLO("inference", Int8Config(), seed=SEED, device=dev)
        m8.quantize(np.random.RandomState(1).rand(8, *ShapesConfig.IMAGE_SHAPE)
                    .astype(np.float32))
        for tag, m in (("float", f32), ("int8", m8)):
            for k in KERNELS.values():
                k.launches = 0
            out = m.detect_batch(images[rows], mesh=mesh)
            torch.cuda.synchronize()
            result["launches"][f"detect_{tag}"] = {n: k.launches for n, k in KERNELS.items()}
            got = host(parallel_mesh.gather_batch(out, mesh))
            if rank == 0:
                exact, measured = detect_parity(got, host(m.detect_batch(images)), m.config)
                result[f"detect_{tag}"] = "bit-equal" if exact else measured
        n8 = result["launches"]["detect_int8"]
        if (n8["fused_ds_block"], n8["fused_mask_branch"], n8["crop_rois"]) != (
                K1_LAUNCHES, K3_LAUNCHES, 0):
            raise AssertionError(f"rank {rank}: int8 detect on the mesh launched {n8}")
        if result["launches"]["detect_float"]["crop_rois"] != 1:
            raise AssertionError(f"rank {rank}: float detect on the mesh did not launch K2 once")
        if rank == 0:
            print(f"[dp] detect_batch(mesh=) on 8 + 8 images vs one call on 16: f32 "
                  f"{result['detect_float']}, int8 {result['detect_int8']}; int8 launches a "
                  f"rank {n8}", flush=True)
    torch.distributed.barrier()
    parallel_distributed.shutdown()
    return result


def phase_parallel(dev, smi, workdir):
    """P1: (a) a world of one over NCCL, (b) DP and (c) TP on two gloo ranks
    sharing the card, each rank a child process. Returns ({kind: rank 0's
    result}, {path: {kernel: launches of each run}})."""
    nccl = run_children("nccl", 1, workdir, CUBLAS_WORKSPACE_CONFIG=":4096:8")[0]
    counts = {"nccl_train": {name: [n] for name, n in nccl["launches"].items()}}
    ranks = {}
    for kind in ("dp", "tp"):
        ranks[kind] = run_children(kind, 2, workdir, LOCAL_RANK="0")
        counts[f"{kind}_train"] = {name: [r["launches"]["train"][name] for r in ranks[kind]]
                                   for name in KERNELS}
        log(f"[parallel] {kind}: ms per step at batch {P1_BATCH}: 2 ranks sharing the card "
            f"(gloo) {[round(r['ms'], 3) for r in ranks[kind]]}, one process "
            f"{ranks[kind][0]['one_process_ms']:.3f}, on {smi} (recorded, not claimed)")
    counts["dp_detect"] = {name: [r["launches"][f"detect_{tag}"][name] for r in ranks["dp"]
                                  for tag in ("float", "int8")] for name in KERNELS}
    return {"nccl": nccl, **{kind: r[0] for kind, r in ranks.items()}}, counts


# ---- phase G1: the graft entry points (mask_yolo_tpu_torch/graft_entry.py) -----

G1_ITERS = 20                      # G1: calls timed of entry()'s fn, eager and exported
G1_LOSS_REL = 1e-4                 # G1: the dryrun's loss on the card against the CPU's


def phase_graft_entry(dev, smi, counts):
    """G1: (a) entry() on the card: its fn eager and its torch.export program
    on 8 seeded noise images, each exactly 1 K2 launch a call, equal to each
    other and to MaskYOLO.detect_batch on the same weights and images (bit
    for bit, else the parity bounds), ms a call (recorded); (b)
    dryrun_multichip(1) over NCCL and (c) dryrun_multichip(2,
    backend="gloo") on two ranks sharing the card (mp 2): each prints the JAX
    dryrun's line with a loss within G1_LOSS_REL of the same step in one
    process on the CPU, step 1 and the detect's batch; its rank 0 counts its
    kernel launches (one K2 forward and backward in the step, one in the
    detect). Returns the JSON line's numbers."""
    from mask_yolo_tpu_torch import graft_entry
    from mask_yolo_tpu_torch.export import custom_op_counts

    t0 = time.perf_counter()
    fn, (state, _) = graft_entry.entry(dev)
    cfg, reference = graft_entry._flagship(graft_entry.ENTRY_BATCH, dev)   # the same weights
    images = torch.tensor(np.random.default_rng(SEED + 12).random(
        (graft_entry.ENTRY_BATCH, *cfg.IMAGE_SHAPE), dtype=np.float32), device=dev)
    eager = host(run_main_path(lambda: fn(state, images), counts.setdefault("g1_entry", {})))
    program = graft_entry.export_entry(fn, (state, images))
    ops = custom_op_counts(program)
    if ops != {"crop_rois": 1}:
        raise AssertionError(f"entry()'s program holds the custom ops {ops}, not one crop_rois")
    run = program.module()
    exported = host(run_main_path(lambda: run(state, images),
                                  counts.setdefault("g1_entry_export", {})))
    for path in ("g1_entry", "g1_entry_export"):
        if counts[path]["crop_rois"] != [1]:
            raise AssertionError(f"{path}: {counts[path]['crop_rois']} K2 launches, not 1")
    reference = host(reference.detect_batch(images))
    result = {"export_ops": ops}
    for tag, got, want in (("export_vs_eager", exported, eager),
                           ("eager_vs_detect_batch", eager, reference)):
        exact, measured = detect_parity(got, want, cfg)
        result[tag] = "bit-equal" if exact else measured
    with torch.no_grad():
        result["eager_ms"] = cuda_ms(lambda: fn(state, images), G1_ITERS, 3)
        result["export_ms"] = cuda_ms(lambda: run(state, images), G1_ITERS, 3)
    log(f"[graft_entry] entry(): fn and its program at batch {graft_entry.ENTRY_BATCH}, bf16: "
        f"{result['export_vs_eager']} to each other, {result['eager_vs_detect_batch']} to "
        f"detect_batch; 1 K2 a call; {result['eager_ms']:.3f} ms eager, "
        f"{result['export_ms']:.3f} ms exported, on {smi} (recorded, not claimed)")
    # the reference: the same step in one process on the CPU (the ranks take
    # this process's TF32 settings: off)
    cpu_loss = graft_entry.dryrun_multichip(1, "cpu")["loss"]
    for n, backend in ((1, None), (2, "gloo")):
        t1 = time.perf_counter()
        r = graft_entry.dryrun_multichip(n, dev, backend=backend)
        if not (np.isfinite(r["loss"]) and r["step"] == 1 and r["detect"][0] == 2 * r["mesh"][0]):
            raise AssertionError(f"dryrun_multichip({n}): {r}")
        if abs(r["loss"] - cpu_loss) > G1_LOSS_REL * abs(cpu_loss):
            raise AssertionError(f"dryrun_multichip({n}): loss {r['loss']} on the card, {cpu_loss} "
                                 f"on the CPU (limit rel {G1_LOSS_REL})")
        if tuple(r["mesh"]) != ((1, 1) if n == 1 else (1, 2)) or \
                r["backend"] != (backend or "nccl"):
            raise AssertionError(f"dryrun_multichip({n}) ran on {r['mesh']} over {r['backend']}")
        train = r["launches"]["train"]
        if (train["crop_rois"], train["crop_rois_backward"]) != (1, 1) or \
                r["launches"]["detect"]["crop_rois"] != 1:
            raise AssertionError(f"dryrun_multichip({n}): K2 launches {r['launches']}")
        for part, launched in r["launches"].items():
            counts[f"g1_dryrun{n}_{part}"] = {k: [v] for k, v in launched.items()}
        result[f"dryrun_{n}"] = {**{k: r[k] for k in ("mesh", "loss", "step", "detect",
                                                      "backend")},
                                 "loss_rel_err": abs(r["loss"] - cpu_loss) / abs(cpu_loss),
                                 "s": time.perf_counter() - t1}
    result["s"] = time.perf_counter() - t0
    log(f"[graft_entry] G1 {result['s']:.1f} s")
    return result


# ---- phase F1: the ResNet-50 + FPN backbone ------------------------------------

FPN_LEVELS = ("P3", "P4", "P5")
# K2 at the pyramid's shapes: Coco416FpnConfig's detect (bf16, MASK_TOP_K 48)
# and TrainFpnConfig's training crop (f32, MASK_TRAIN_TOP_ROIS 32), every
# level cropped on all K ROIs
FPN_FWD_SHAPES = {
    **{f"fpn416_{lv}": dict(dtype=torch.bfloat16, b=16, h=side, w=side, c=256, k=48, pool=14)
       for lv, side in zip(FPN_LEVELS, (52, 26, 13))},
    **{f"fpn224_{lv}": dict(dtype=torch.float32, b=16, h=side, w=side, c=256, k=32, pool=14)
       for lv, side in zip(FPN_LEVELS, (28, 14, 7))}}
FPN_BWD_SHAPES = [dict(b=16, h=side, w=side, c=256, k=32, pool=14) for side in (28, 14, 7)]
FPN_BATCH, FPN_CALIB, FPN_TRAIN_STEPS = 16, 8, 2
FPN_EXPORT_BATCHES = (1, 16)
FPN_SCORE_TOL = 1e-5               # (c): the hybrid's scores against the float detect's
# (c): int8 mask probabilities against the float head's on the same ROIs, the
# bound of the JAX package's test_hybrid_quantization_resnet_fpn, held as
# there on a network of flax's default initializers. The He-normal weights
# of the smoke's other models drive the mask logits to hundreds, where the
# per-tensor int8 grid flips whole pixels (a CPU run at 416²: max 1.0, mean
# 0.030, against 0.005 and 0.0005 on flax's initializers); that model's
# figure is recorded beside it.
FPN_MASK_MAX, FPN_MASK_MEAN = 0.05, 0.02
FPN_LAUNCHES = {"crop_rois": 3, "crop_rois_backward": 0, "fused_ds_block": 0,
                "fused_mask_branch": 0}


def level_spread_boxes(rng, b, k):
    """Boxes of sides 0.05-1.0 (normalized), so that at 416² FPN eq. 1 sends
    them to all three levels, the first two of each image off the map."""
    side = rng.uniform(0.05, 1.0, (b, k, 2))
    corner = rng.uniform(0.0, 1.0, (b, k, 2)) * (1.0 - side)
    boxes = np.concatenate([corner, corner + side], axis=-1)
    boxes[:, 0] = [-0.2, -0.1, 0.5, 0.6]
    boxes[:, 1] = [0.6, 0.55, 1.3, 1.2]
    return boxes.astype(np.float32)


def check_multilevel(dev, rng, dtype, b, k, sides, hw, backward):
    """multilevel_crop_rois (one K2 call a level) against its plain twin
    multilevel_crop_and_resize on the same pyramid: the levels the card
    assigns equal the CPU's, each ROI's crop is its level's K2 crop exactly,
    the values within CROP_TOL; with `backward`, the gradient into every
    level (one K2 backward a level) within BWD_TOL of autograd through the
    plain twin."""
    maps = [torch.tensor(rng.standard_normal((b, side, side, 256), dtype=np.float32),
                         device=dev).to(dtype) for side in sides]
    boxes_np = level_spread_boxes(rng, b, k)
    boxes = torch.tensor(boxes_np, device=dev)
    level = fpn_levels(boxes, len(maps), hw)
    same_levels = torch.equal(level.cpu(), fpn_levels(torch.tensor(boxes_np), len(maps), hw))
    got = multilevel_crop_rois(maps, boxes, 14, hw)
    want = multilevel_crop_and_resize(maps, boxes, (14, 14), image_hw=hw)
    own = all(torch.equal(got[level == i], crop_rois(m, boxes, 14)[level == i])
              for i, m in enumerate(maps))
    ratio = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    used = torch.bincount(level.flatten(), minlength=len(maps)).tolist()
    tag = f"{str(dtype)[6:]} B={b} K={k} {'/'.join(f'{s}²' for s in sides)} at {hw[0]}²"
    txt = ""
    if backward:
        g = torch.tensor(rng.standard_normal(tuple(got.shape), dtype=np.float32), device=dev)
        leaves = [m.detach().clone().requires_grad_() for m in maps]
        before = crop_rois_backward.launches
        (multilevel_crop_rois(leaves, boxes, 14, hw) * g).sum().backward()
        n_bwd = crop_rois_backward.launches - before
        plain = [m.detach().clone().requires_grad_() for m in maps]
        (multilevel_crop_and_resize(plain, boxes, (14, 14), image_hw=hw) * g).sum().backward()
        bwd = max(((a.grad - p.grad).abs().max() / p.grad.abs().max()).item()
                  for a, p in zip(leaves, plain))
        txt = (f"; backward, {n_bwd} K2 backward launches, max|kernel-plain| / max|plain| "
               f"{bwd:.3e} (limit {BWD_TOL[dtype]})")
        if n_bwd != len(maps) or not bwd <= BWD_TOL[dtype]:
            raise AssertionError(f"the multi-level crop's backward disagrees ({tag})")
    log(f"[fpn] multi-level crop {tag}: ROIs a level {used}, levels card = CPU {same_levels}, "
        f"each ROI its level's K2 crop {own}, max|kernel-plain| / max|plain| {ratio:.3e} "
        f"(limit {CROP_TOL[dtype]}){txt}")
    if not (same_levels and own and ratio <= CROP_TOL[dtype]):
        raise AssertionError(f"the multi-level crop disagrees with its plain twin ({tag})")


def fpn_plain_branch(head):
    """The mask branch with the plain multi-level crop in place of K2."""
    return lambda rois, pyramid: head.from_crops(multilevel_crop_and_resize(
        tuple(pyramid), rois.float(), (head.pool_size, head.pool_size),
        image_hw=head.image_hw).to(head.dtype))


def expect_launches(counts, what, want):
    got = {name: counts[name][-1] for name in KERNELS}
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")
    return got


def phase_fpn(dev, smi, rng, new_crop, workdir, counts):
    """F1: K2 at the pyramid's shapes and the multi-level crop on the card;
    detect, int8 hybrid, train and export through the FPN network. counts:
    {path: {kernel: launches of each run}}, filled. Returns the JSON
    results."""
    fwd = phase_kernel(dev, rng, new_crop, shapes=FPN_FWD_SHAPES, edges=False)
    bwd = phase_train_kernel(dev, rng, new_crop, torch.float32, shapes=FPN_BWD_SHAPES,
                             edges=False)
    check_multilevel(dev, rng, torch.bfloat16, FPN_BATCH, 48, (52, 26, 13), (416, 416), False)
    check_multilevel(dev, rng, torch.float32, FPN_BATCH, 32, (28, 14, 7), (224, 224), True)
    result = {"kernels": {"forward": fwd, "backward": dict(zip(FPN_LEVELS, bwd))}}

    # (b) detect at 416²
    cfg = Coco416FpnConfig()
    h, w = cfg.IMAGE_SHAPE[:2]
    t0 = time.perf_counter()
    images_np = dense_images(FPN_BATCH + FPN_CALIB, SEED + 9, h)
    images = torch.as_tensor(images_np[:FPN_BATCH], device=dev)
    calib = images_np[FPN_BATCH:]
    model = MaskYOLO("inference", cfg, seed=SEED, device=dev)
    log(f"[fpn] {len(images_np)} DenseShapes scenes at {h}² and the ResNet-50 + FPN model "
        f"({sum(p.numel() for p in model.net.parameters()) / 1e6:.2f} M parameters, bf16) in "
        f"{time.perf_counter() - t0:.1f} s")
    out = run_main_path(lambda: model.detect_batch(images), counts.setdefault("fpn_detect", {}))
    check_outputs(out, cfg, FPN_BATCH, "FPN bf16")
    launched = expect_launches(counts["fpn_detect"], "the FPN detect", FPN_LAUNCHES)
    kp = cfg.MASK_TOP_K
    scale = torch.tensor([w, h, w, h], device=dev)
    with torch.inference_mode():
        x = images_f32(images)
        grid, pyramid = model.net.trunk_pyramid(x)
        head = model.net.mask
        out_k = detect_from_callables(lambda _: (grid, pyramid), model.net.mask_branch, x, cfg)
        out_p = detect_from_callables(lambda _: (grid, pyramid), fpn_plain_branch(head), x, cfg)
        rois = (out["boxes"][:, :kp] / scale).contiguous()
        ms = cuda_ms(lambda: model.detect_batch(images), 5, 2)
        trunk_ms = cuda_ms(lambda: model.net.trunk_pyramid(x), 5, 2)
        crops = multilevel_crop_rois(pyramid, rois, head.pool_size, head.image_hw)
        crop_ms = cuda_ms(lambda: multilevel_crop_rois(pyramid, rois, head.pool_size,
                                                       head.image_hw), 20, 3)
        conv_ms = cuda_ms(lambda: head.from_crops(crops.to(head.dtype)), 5, 2)
    for key in ("boxes", "classes", "scores", "valid"):
        if not torch.equal(out_k[key], out_p[key]):
            raise AssertionError(f"FPN detect: {key} differ between K2 and the plain crop")
    agree = (out_k["masks"] == out_p["masks"]).float().mean().item()
    levels = torch.bincount(fpn_levels(rois, 3, (h, w)).flatten(), minlength=3).tolist()
    rest = ms - trunk_ms - crop_ms - conv_ms
    log(f"[fpn] bf16 detect_batch B={FPN_BATCH}: {int(out['valid'].sum())} valid detections, "
        f"{int(out['masks'].sum())} mask pixels; launches {launched}; the batch's "
        f"{FPN_BATCH * kp} ROIs by level {levels}; K2 vs the plain multi-level crop: boxes, "
        f"classes, scores, valid identical, masks agree on {agree:.6f} of pixels (limit "
        f"{MASK_AGREE}); {ms:.3f} ms/batch ({FPN_BATCH * 1e3 / ms:.1f} img/s) = trunk "
        f"{trunk_ms:.3f} + 3 K2 crops {crop_ms:.3f} + mask convs {conv_ms:.3f} + the rest "
        f"~{rest:.3f} ms on {smi} (recorded, not claimed)")
    if agree < MASK_AGREE:
        raise AssertionError("FPN detect: masks disagree between K2 and the plain crop")
    result["detect"] = {"ms": ms, "trunk_ms": trunk_ms, "crops_ms": crop_ms,
                        "mask_convs_ms": conv_ms, "rest_ms": rest, "mask_agree": agree,
                        "rois_by_level": levels}

    # (e) export: the bf16 artifact with a symbolic batch, in a child process
    t0 = time.perf_counter()
    model.export_model(workdir / "fpn.pt2")
    export_s = time.perf_counter() - t0
    np.save(workdir / "fpn_images.npy", images_np[:FPN_BATCH])
    live = {b: host(model.detect_batch(images_np[:b])) for b in FPN_EXPORT_BATCHES}
    child = run_children("export_fpn", 1, workdir)[0]
    outputs = np.load(workdir / "fpn_out.npz")
    counts["fpn_export"] = {name: [c[name] for c in child["per_call"]] for name in KERNELS}
    if any(c != FPN_LAUNCHES for c in child["per_call"]) \
            or child["graph_ops"] != {"crop_rois": 3}:
        raise AssertionError(f"the FPN artifact launched {child['per_call']}, graph "
                             f"{child['graph_ops']}; expected 3 crop_rois a call")
    for b in FPN_EXPORT_BATCHES:
        got = {k[len(f"{b}."):]: outputs[k] for k in outputs.files if k.startswith(f"{b}.")}
        if not all(np.array_equal(got[k], live[b][k]) for k in live[b]):
            raise AssertionError(f"the FPN artifact at batch {b} is not bit-equal to the live "
                                 f"detect_batch")
    log(f"[fpn] export_model (symbolic batch) {export_s:.1f} s, "
        f"{(workdir / 'fpn.pt2').stat().st_size / 2**20:.1f} MiB; child load "
        f"{child['load_s']:.1f} s, graph custom ops {child['graph_ops']}, launches a call "
        f"{child['per_call'][0]}; at batch {', '.join(map(str, FPN_EXPORT_BATCHES))} bit-equal "
        f"to the live detect_batch")
    result["export"] = {"export_s": export_s, "load_s": child["load_s"],
                        "graph_ops": child["graph_ops"]}

    # (c) the int8 hybrid: the float trunk, the int8 mask head (K2, no K1 or K3)
    fused = type("Coco416FpnFusedConfig", (Coco416FpnConfig,), {"QUANT_FUSED_MASK": True})()
    try:
        quant.QuantizedDetector.from_variables(
            weights.to_jax_variables(model._host_state), fused, calib, device=dev, net=model.net)
    except ValueError as e:
        refused = str(e).split(":")[0]
    else:
        raise AssertionError("QUANT_FUSED_MASK on the FPN network did not raise")
    t0 = time.perf_counter()
    det = model.quantize(calib)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    out8 = run_main_path(lambda: model.detect_batch(images), counts.setdefault("fpn_int8", {}))
    check_outputs(out8, cfg, FPN_BATCH, "FPN int8 hybrid")
    expect_launches(counts["fpn_int8"], "the FPN int8 hybrid detect", FPN_LAUNCHES)
    score_err = (out8["scores"] - out["scores"]).abs().max().item()
    with torch.inference_mode():
        he = (det.mask_branch(rois, pyramid) - model.net.mask_branch(rois, pyramid)).abs()
        ms8 = cuda_ms(lambda: model.detect_batch(images), 5, 2)
    del model, det, pyramid, grid, crops
    torch.cuda.empty_cache()
    # the JAX test's setting: flax's default initializers, quantized on the
    # same images, on the same ROIs
    flat = MaskYOLO("inference", cfg, seed=SEED, device=dev)
    flat.net.init_flax_defaults(torch.Generator().manual_seed(SEED))
    flat._sync_host_state()
    flat_det = flat.quantize(calib)
    with torch.inference_mode():
        pyramid = flat.net.trunk_pyramid(x)[1]
        d = (flat_det.mask_branch(rois, pyramid) - flat.net.mask_branch(rois, pyramid)).abs()
    log(f"[fpn] int8 hybrid: quantize ({FPN_CALIB} images) {quant_s:.1f} s; QUANT_FUSED_MASK "
        f"refused ({refused}); launches {FPN_LAUNCHES}; classes equal to the float detect's "
        f"{torch.equal(out8['classes'], out['classes'])}, scores max|d| {score_err:.3e} (limit "
        f"{FPN_SCORE_TOL}); int8 vs float mask probabilities on the batch's "
        f"{FPN_BATCH * kp} ROIs, flax's initializers: max {d.max().item():.4f} (limit "
        f"{FPN_MASK_MAX}), mean {d.mean().item():.5f} (limit {FPN_MASK_MEAN}); He-normal "
        f"(recorded): max {he.max().item():.4f}, mean {he.mean().item():.5f}; {ms8:.3f} "
        f"ms/batch on {smi} (recorded, not claimed)")
    if not (torch.equal(out8["classes"], out["classes"]) and score_err <= FPN_SCORE_TOL
            and d.max().item() <= FPN_MASK_MAX and d.mean().item() <= FPN_MASK_MEAN):
        raise AssertionError("the FPN int8 hybrid disagrees with the float path")
    result["int8"] = {"ms": ms8, "quantize_s": quant_s, "score_err": score_err,
                      "mask_max": d.max().item(), "mask_mean": d.mean().item(),
                      "he_normal_mask_max": he.max().item(),
                      "he_normal_mask_mean": he.mean().item()}
    del flat, flat_det, pyramid, x, he, d
    torch.cuda.empty_cache()

    # (d) two f32 train steps at 224²
    tcfg = TrainFpnConfig()
    ds = shapes_dataset(FPN_BATCH, SEED, tcfg)
    batch = to_device(BatchGenerator(preload_dataset(ds, tcfg), tcfg, shuffle=False)[0], dev)
    tmodel = MaskYOLO("training", tcfg, seed=SEED, device=dev)
    tx = record_first_update(train_state.make_optimizer(1e-3, tcfg,
                                                        dict(tmodel.net.named_parameters())))
    state = train_state.create_train_state(tmodel.net, tx)
    step = trainer.make_train_step(tcfg, tx)
    losses = []
    for _ in range(FPN_TRAIN_STEPS):
        _, metrics = run_main_path(lambda: step(state, batch),
                                   counts.setdefault("fpn_train", {}),
                                   ("crop_rois", "crop_rois_backward"))
        losses.append(metrics["loss"].item())
        expect_launches(counts["fpn_train"], "the FPN train step",
                        {**FPN_LAUNCHES, "crop_rois_backward": 3})
    # record_first_update keeps the gradients that exist: the neck's is None
    neck = [k for k in tx.keys if k.startswith("feature_map.")]
    neck_ok = len(neck) == 2 and all(k not in tx.seen or not tx.seen[k].any() for k in neck)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, batch), 5, 2)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[fpn] train step, batch {tcfg.BATCH_SIZE}, {tcfg.IMAGE_SHAPE[0]}², f32: losses "
        f"{[round(v, 4) for v in losses]}, K2 forward and backward 3 + 3 a step; the neck's "
        f"gradient None or zero {neck_ok}; {step_ms:.3f} ms/step, peak {peak:.0f} MiB on {smi} "
        f"(recorded, not claimed)")
    if not (np.isfinite(losses).all() and neck_ok):
        raise AssertionError("the FPN train step failed (loss or the neck's gradient)")
    result["train"] = {"step_ms": step_ms, "peak_mib": peak, "losses": losses}
    return result


def child_export_fpn(dev, workdir):
    """F1(e)'s child: loads the FPN artifact with nothing but the export
    module and runs it at FPN_EXPORT_BATCHES."""
    from mask_yolo_tpu_torch.export import ExportedDetector, custom_op_counts

    images = np.load(workdir / "fpn_images.npy")
    t0 = time.perf_counter()
    det = ExportedDetector.load(workdir / "fpn.pt2")
    load_s = time.perf_counter() - t0
    per_call, outputs = [], {}
    for b in FPN_EXPORT_BATCHES:
        for k in KERNELS.values():
            k.launches = 0
        out = det.detect_batch(images[:b])
        torch.cuda.synchronize()
        per_call.append({name: k.launches for name, k in KERNELS.items()})
        outputs.update({f"{b}.{k}": v for k, v in host(out).items()})
    np.savez(workdir / "fpn_out.npz", **outputs)
    return {"load_s": load_s, "graph_ops": custom_op_counts(det.program), "per_call": per_call}


CHILDREN = {"export": child_export, "export_fpn": child_export_fpn, "nccl": child_nccl,
            "dp": lambda dev, workdir: child_mesh("dp", dev, workdir),
            "tp": lambda dev, workdir: child_mesh("tp", dev, workdir)}


# ---- phase C1: the command-line entry points ----------------------------------

REPO = Path(__file__).resolve().parent
TOOL_TIMEOUT_S = 300               # C1: a tool's process that runs longer is killed
C1_IMAGES, C1_REQUESTS = 8, 8      # predict's PNGs (one batch of 8), serve's requests
C1_TRAIN = ("--train-images", "32", "--val-images", "8", "--epochs", "1")
# predict's COCO results and serve's answers against the in-process path:
# ids equal, scores and boxes (px) within these, masks equal on this share
C1_SCORE, C1_BOX_PX, C1_MASK = 1e-5, 1e-3, 0.999


def tool(module, *argv):
    """`python -m mask_yolo_tpu_torch.<module> argv` from the repository
    root, as a user runs it; killed after TOOL_TIMEOUT_S. Returns (stdout,
    seconds); raises if it exits non-zero."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"mask_yolo_tpu_torch.{module}",
                           *map(str, argv)], cwd=REPO, capture_output=True, text=True,
                          timeout=TOOL_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-5000:]}")
    return proc.stdout, time.perf_counter() - t0


class TorchDefaults:
    """TF32 as torch sets it by default (on for cuDNN, off for matmul), as
    the tools run it in their own processes: the in-process references of
    C1 compute what the tools compute."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def rle_agree(got, want):
    """The share of pixels two COCO uncompressed RLE masks agree on."""
    shape = tuple(want["size"])
    if tuple(got["size"]) != shape:
        return 0.0
    return float(np.mean(rle_decode_counts(got["counts"], shape)
                         == rle_decode_counts(want["counts"], shape)))


def compare_results(what, got, want):
    """Two COCO results lists entry for entry at C1's bounds: {measured};
    raises beyond them or if a list is empty."""
    if not want or len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results against {len(want)}")
    score = box = 0.0
    agree = 1.0
    for g, w in zip(got, want):
        if (g["image_id"], g["category_id"]) != (w["image_id"], w["category_id"]):
            raise AssertionError(f"{what}: ids {g['image_id'], g['category_id']} against "
                                 f"{w['image_id'], w['category_id']}")
        score = max(score, abs(g["score"] - w["score"]))
        box = max(box, float(np.abs(np.subtract(g["bbox"], w["bbox"])).max()))
        agree = min(agree, rle_agree(g["segmentation"], w["segmentation"]))
    if score > C1_SCORE or box > C1_BOX_PX or agree < C1_MASK:
        raise AssertionError(f"{what}: scores {score:.3g} (limit {C1_SCORE}), boxes {box:.3g} px "
                             f"(limit {C1_BOX_PX}), masks agree {agree:.6f} (limit {C1_MASK})")
    return {"results": len(got), "exact": got == want, "max_score_err": score,
            "max_box_err_px": box, "min_mask_agree": agree}


def compare_served(what, got, want):
    """Served answers ({detections: [...]} with RLE masks) against the
    in-process executor's at C1's bounds: {measured}."""
    score = box = 0.0
    agree, n = 1.0, 0
    for g, w in zip(got, want, strict=True):
        if [(d["class_id"], d["label"]) for d in g["detections"]] != [
                (d["class_id"], d["label"]) for d in w["detections"]]:
            raise AssertionError(f"{what}: classes differ from the in-process executor's")
        for gd, wd in zip(g["detections"], w["detections"]):
            score = max(score, abs(gd["score"] - wd["score"]))
            box = max(box, float(np.abs(np.subtract(gd["box"], wd["box"])).max()))
            agree = min(agree, float(np.mean(rle_to_mask(gd["mask_rle"], gd["mask_shape"])
                                             == rle_to_mask(wd["mask_rle"], wd["mask_shape"]))))
            n += 1
    if not n or score > C1_SCORE or box > C1_BOX_PX or agree < C1_MASK:
        raise AssertionError(f"{what}: {n} detections, scores {score:.3g}, boxes {box:.3g} px, "
                             f"masks agree {agree:.6f}")
    return {"detections": n, "exact": got == want, "max_score_err": score,
            "max_box_err_px": box, "min_mask_agree": agree}


def start_server(argv, log_path):
    """Start `tools.serve_model argv --port 0`, stderr to log_path. The
    caller kills the process."""
    with open(log_path, "w") as log_file:
        return subprocess.Popen([sys.executable, "-m", "mask_yolo_tpu_torch.tools.serve_model",
                                 *map(str, argv), "--port", "0"], cwd=REPO,
                                stdout=subprocess.PIPE, stderr=log_file, text=True)


def serving_port(proc, log_path):
    """Wait (TOOL_TIMEOUT_S at most) for a server's "serving on
    http://host:port" line; returns the port."""
    import select

    deadline = time.perf_counter() + TOOL_TIMEOUT_S
    while time.perf_counter() < deadline and proc.poll() is None:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        line = proc.stdout.readline() if ready else ""
        if line.startswith("serving on http://"):
            return int(line.split()[2].rsplit(":", 1)[1])
    raise AssertionError(f"serve_model did not start:\n{Path(log_path).read_text()[-4000:]}")


def post_detect(port, image):
    import io
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, image)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/detect", data=buf.getvalue(),
                                 method="POST", headers={"X-Include-Masks": "1"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def phase_entry_points(dev, smi, workdir, counts):
    """C1: the command-line entry points as child processes, `python -m`
    from the repository root. (a) train_shapes, 1 epoch on 32 images; (f)
    gen_anchors --dataset shapes --k 3 beside it; (b) predict on 8 seeded
    Shapes PNGs with (a)'s checkpoint and config.json (OBJ_THRESHOLD 0: a
    one-epoch model scores low), float and --quantize with Int8Config's
    knobs, each held to the in-process detect_batch on the same images and
    weights, and predict.run in-process under the launch counts (1 K2 a
    float batch; 10 K1 + 1 K3 an int8 batch); (c) export_model --verify on
    (a)'s weights beside them; (d) serve_model from a seeded checkpoint
    (spread scores) and from (c)'s artifact, 8 HTTP requests each, against
    the in-process BatchingExecutor; (e) bench's JSON line with the three
    paths. Returns C1's results."""
    t_phase = time.perf_counter()
    res, seconds = {}, {}
    ckpt_dir, pngs = workdir / "ckpt", workdir / "images"
    pool = ThreadPoolExecutor(max_workers=3)
    try:
        train = pool.submit(tool, "examples.shapes.train_shapes", *C1_TRAIN,
                            "--model-dir", ckpt_dir)
        anchors = pool.submit(tool, "tools.gen_anchors", "--dataset", "shapes", "--k", "3",
                              "--out", workdir / "anchors_3.txt")
        from PIL import Image

        pngs.mkdir(parents=True)
        for i, image in enumerate(shapes_dataset_images(C1_IMAGES, SEED + 9)):
            Image.fromarray(image).save(pngs / f"{i}.png")
        _, seconds["train"] = train.result()
        (ckpt,) = ckpt_dir.glob("saved_model_*_e0001.pt")
        config = json.loads((ckpt_dir / "config.json").read_text())
        cfg_json = {"float": {**config, "OBJ_THRESHOLD": 0.0}}
        cfg_json["int8"] = {**cfg_json["float"], **{k: v for k, v in vars(Int8Config).items()
                                                    if k.isupper()}}
        for tag, fields in cfg_json.items():
            (workdir / f"{tag}.json").write_text(json.dumps(fields))

        def predict_argv(tag):
            return ["--weights", ckpt, "--config-json", workdir / f"{tag}.json", "--images", pngs,
                    "--out", workdir / f"predict_{tag}.json", "--score-threshold", "0",
                    *(["--quantize"] if tag == "int8" else [])]

        runs = {tag: pool.submit(tool, "tools.predict", *predict_argv(tag))
                for tag in ("float", "int8")}
        export = pool.submit(tool, "tools.export_model", "--weights", ckpt, "--config-json",
                             workdir / "float.json", "--out", workdir / "detect.pt2", "--verify")
        with TorchDefaults():
            for tag in ("float", "int8"):
                args = predict.parser().parse_args([str(a) for a in predict_argv(tag)])
                args.out, args.device = str(workdir / f"inprocess_{tag}.json"), str(dev)
                cfg = predict.build_config(args)
                run_main_path(lambda: predict.run(cfg, args), counts.setdefault(tag, {}),
                              expect=("crop_rois",) if tag == "float"
                              else ("fused_ds_block", "fused_mask_branch"))
                # the reference: detect_batch on the same images and weights
                model = MaskYOLO("inference", cfg, device=dev)
                model.load_weights(str(ckpt))
                loaded = [predict.load_image(pngs / f"{i}.png", cfg.IMAGE_SHAPE[:2])
                          for i in range(C1_IMAGES)]
                batch = np.stack([l[1] for l in loaded])
                if tag == "int8":
                    model.quantize(batch)
                out = host(model.detect_batch(batch))
                want = []
                for i, (_, _, scale) in enumerate(loaded):
                    idx = np.where(out["valid"][i])[0]
                    want += detections_to_coco_results(
                        i, out["boxes"][i][idx], out["classes"][i][idx], out["scores"][i][idx],
                        np.transpose(out["masks"][i][idx], (1, 2, 0)), scale=scale)
                stdout, seconds[f"predict_{tag}"] = runs[tag].result()
                got = json.loads((workdir / f"predict_{tag}.json").read_text())
                res[f"predict_{tag}"] = compare_results(f"predict {tag}", got, want)
                res[f"predict_{tag}"]["launches"] = {k: v[-1] for k, v in counts[tag].items()}
                del model
        launched = {tag: {k: v[-1] for k, v in counts[tag].items()} for tag in counts}
        if (launched["float"]["crop_rois"] != 1 or launched["int8"]["fused_ds_block"] != K1_LAUNCHES
                or launched["int8"]["fused_mask_branch"] != K3_LAUNCHES):
            raise AssertionError(f"predict's launches for one batch: {launched} (expected 1 K2 "
                                 f"float, {K1_LAUNCHES} K1 + {K3_LAUNCHES} K3 int8)")
        stdout, seconds["export_verify"] = export.result()
        if "verify: artifact matches live model" not in stdout:
            raise AssertionError(f"export_model --verify printed no verdict:\n{stdout}")
        stdout, seconds["gen_anchors"] = anchors.result()
        with TorchDefaults():
            want_anchors, _ = gen_anchors.run(ShapesConfig(), gen_anchors.parser().parse_args(
                ["--dataset", "shapes", "--k", "3", "--out", str(workdir / "anchors_ref.txt")]))
        if (workdir / "anchors_3.txt").read_bytes() != (workdir / "anchors_ref.txt").read_bytes():
            raise AssertionError("gen_anchors' file differs from the in-process run's")
        res["gen_anchors"] = [float(x) for x in want_anchors.reshape(-1)]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # (d) serve: a seeded checkpoint whose scores pass OBJ_THRESHOLD, and
    # (c)'s artifact (OBJ_THRESHOLD 0)
    seeded = spread_scores(MaskYOLO("inference", ShapesConfig(), seed=SEED, device=dev))
    seeded.save_weights(str(workdir / "serve.pt"))
    del seeded
    requests = shapes_dataset_images(C1_REQUESTS, SEED + 10)
    servers = {"weights": ["--weights", workdir / "serve.pt", "--config", "shapes"],
               "artifact": ["--artifact", workdir / "detect.pt2"]}
    procs = {}
    try:
        t0 = time.perf_counter()
        for tag, argv in servers.items():   # both start at once
            procs[tag] = start_server(argv, workdir / f"serve_{tag}.log")
        ports = {tag: serving_port(proc, workdir / f"serve_{tag}.log")
                 for tag, proc in procs.items()}
        seconds["serve_start"] = time.perf_counter() - t0
        for tag, port in ports.items():
            got = [post_detect(port, image) for image in requests]
            if tag == "weights":
                cfg = type("ServeConfig", (ShapesConfig,), {"BATCH_SIZE": 8})()
                model = MaskYOLO("inference", cfg, device=dev)
                model.load_weights(str(workdir / "serve.pt"))
            else:
                model = ExportedDetector.load(workdir / "detect.pt2", device=dev)
                cfg = model.serve_config()
            ex = BatchingExecutor(model, cfg, batch_size=cfg.BATCH_SIZE)
            try:
                with TorchDefaults():
                    want = [ex.detect(image, include_masks=True) for image in requests]
            finally:
                ex.shutdown()
            res[f"serve_{tag}"] = compare_served(f"serve {tag}", got, want)
            del model
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    seconds["serve"] = time.perf_counter() - t0

    # (e) bench, alone on the card
    stdout, seconds["bench"] = tool("bench")
    bench = json.loads(stdout.strip().splitlines()[-1])
    if set(bench["per_path"]) != {"bf16", "int8", "int8_fused"} or not all(
            v > 0 for v in bench["per_path"].values()):
        raise AssertionError(f"bench: {bench}")
    res["bench"] = bench
    seconds["phase"] = time.perf_counter() - t_phase
    res["seconds"] = seconds
    log(f"[entry points] {json.dumps(res)}")
    log(f"[entry points] bench at batch {bench['batch_size']}: {bench['per_path']} img/s on "
        f"{smi}; C1 took {seconds['phase']:.1f} s (recorded, not claimed)")
    return res


# ---- phase M1: the measurement tools -------------------------------------------

# rates each reading may reach: 105 % of the H100 SXM5's dense data-sheet peaks
ROOFLINE_SPEC = {"bfloat16": 989.4, "int8": 1978.9, "tf32": 494.7, "float32": 66.9}   # T/s
HBM_SPEC_GBPS = 3350.0
SPEC_MARGIN = 1.05
M1_BATCH, M1_STAGES_BATCH, M1_TRAIN_IMAGES, M1_AB_IMAGES = 16, 128, 64, 8
# the fields of a tool's row that are times or rates: each finite and > 0
M1_TIMINGS = ("ms", "us_per_img", "img_per_s", "tops", "gbps", "eff_tops", "gemm_us_per_img",
              "gemm_tops", "cum_us_per_img", "live_img_per_s", "artifact_img_per_s",
              "live_ms", "artifact_ms", "device_only_images_per_sec", "step_ms",
              "e2e_images_per_sec", "e2e_sec_per_step", "device_busy_share",
              "sum_isolated_us_per_img")


def tool_args(module, *argv):
    return module.parser().parse_args([*map(str, argv), "--device", "cuda"])


def check_rows(name, rows):
    """M1's holds on a tool's rows: no error line, every timing finite and
    > 0."""
    if not rows:
        raise AssertionError(f"{name}: no rows")
    for r in rows:
        if "error" in r:
            raise AssertionError(f"{name}: error row {r}")
        for key in M1_TIMINGS:
            if key in r and not (r[key] is not None and np.isfinite(r[key]) and r[key] > 0):
                raise AssertionError(f"{name}: {key} = {r[key]} in {r}")
    return rows


def launches_of(fn):
    """{kernel: launches} of one call of fn (its outputs computed once)."""
    for k in KERNELS.values():
        k.launches = 0
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in KERNELS.items()}


def same_call(what, tool_fn, library_fn):
    """The tool's callable against the library entry point on the same
    batch: outputs bit for bit, and the same launches of each kernel."""
    got, got_n = launches_of(tool_fn)
    want, want_n = launches_of(library_fn)
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in got):
        raise AssertionError(f"{what}: the tool's outputs differ from the library call's")
    if got_n != want_n:
        raise AssertionError(f"{what}: launches {got_n}, the library call's {want_n}")
    return got_n


def expect_counts(what, got, want):
    """`want`: the launches of the same path in an earlier phase."""
    if any(got[name] != n for name, n in want.items()):
        raise AssertionError(f"{what}: launches {got}, the earlier phase's {want}")


def phase_measurement_tools(dev, smi, workdir, counts, coco_counts):
    """M1: each tool of mask_yolo_tpu_torch/tools called in-process through
    run(config, args) at a small size under the launch counts, its rows
    held (no error line, timings finite and > 0), its timed callables held
    bit for bit to the library entry point on the same batch with the same
    launches a call (those of phases 4 and Q2 where the path is theirs),
    and bench_roofline's readings at most 105 % of the card's data sheet.
    Returns {tool: [rows]} and the seconds."""
    from mask_yolo_tpu_torch.tools import (_timing, ab_infer_yolo_exactness, bench_416,
                                           bench_export, bench_roofline, bench_train,
                                           profile_infer_yolo, profile_layers_416,
                                           profile_stages, profile_stages_416)

    t_start = time.perf_counter()
    out, per_call = {}, {}

    def drive(name, fn, expect=()):
        t0 = time.perf_counter()
        rows = check_rows(name, run_main_path(fn, counts.setdefault(name, {}), expect))
        out[name] = rows
        log(f"[tools] {name}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s; launches "
            f"{ {k: v[-1] for k, v in counts[name].items()} }")
        return rows

    with TorchDefaults():
        # (1) bench_roofline: the card's measured peaks against its data sheet
        rows = drive("bench_roofline", lambda: bench_roofline.run(None, tool_args(bench_roofline)))
        for r in rows:
            spec = (HBM_SPEC_GBPS if "gbps" in r else
                    ROOFLINE_SPEC["tf32" if r.get("tf32") else r["dtype"]])
            reading = r.get("gbps", r.get("tops"))
            log(f"[tools] roofline {r.get('dtype', r.get('probe'))}: {reading:.1f} "
                f"({100 * reading / spec:.1f} % of the data sheet's {spec}) on {smi}")
            if reading > SPEC_MARGIN * spec:
                raise AssertionError(f"bench_roofline reads {reading} > 105 % of {spec}: a "
                                     f"timing fault")

        # (2) profile_stages, ShapesConfig bf16 224^2, batch 128
        cfg = profile_stages.bench_config()
        args = tool_args(profile_stages, M1_STAGES_BATCH)
        drive("profile_stages", lambda: profile_stages.run(cfg, args), ("crop_rois",))
        model = _timing.seeded_model(cfg, args)
        images = _timing.seeded_images(M1_STAGES_BATCH, cfg.IMAGE_SHAPE, dev)
        full = dict(profile_stages.build_stages(model.net, cfg))["full"]
        per_call["profile_stages"] = same_call(
            "profile_stages full", lambda: full(images),
            lambda: detect_outputs(model.net, images, cfg))
        expect_counts("profile_stages full", per_call["profile_stages"], {"crop_rois": 1})
        del model, images

        # (3)-(5) the 416^2 int8 tools, batch 16
        cfg = profile_stages_416.bench_config()
        args = tool_args(profile_stages_416, "--batch", M1_BATCH)
        drive("profile_stages_416", lambda: profile_stages_416.run(cfg, args), ("crop_rois",))
        model = _timing.seeded_model(cfg, args)
        det = _timing.quantized(model, cfg, dev)
        images = _timing.seeded_images(M1_BATCH, cfg.IMAGE_SHAPE, dev)
        full = dict(profile_stages_416.build_stages(det, cfg))["full"]
        per_call["profile_stages_416"] = same_call(
            "profile_stages_416 full", lambda: full(images), lambda: det.detect_outputs(images))
        args = tool_args(profile_infer_yolo, "--batch", M1_BATCH)
        drive("profile_infer_yolo",
              lambda: profile_infer_yolo.run(profile_infer_yolo.run_config(args), args))
        full = dict(profile_infer_yolo.build_stages(det, cfg))["full"]
        per_call["profile_infer_yolo"] = same_call(
            "profile_infer_yolo full", lambda: full(images),
            lambda: det.infer_yolo_outputs(images))
        # the full stage against +nms, split into device kernels and host gaps
        stages = dict(profile_infer_yolo.build_stages(det, cfg))
        infer_split = {tag: call_split(lambda tag=tag: stages[tag](images))
                       for tag in ("+nms", "full")}
        for tag, r in infer_split.items():
            log(f"[tools] profile_infer_yolo {tag} split, batch {M1_BATCH}: {r} on {smi}")
        args = tool_args(profile_layers_416, "--batch", M1_BATCH)
        drive("profile_layers_416", lambda: profile_layers_416.run(cfg, args))

        # (6) bench_416: every path, per channel, and the FPN hybrid's int8
        q2_pt = {name: coco_counts[name][1] for name in KERNELS}   # Q2's int8 per tensor
        for tag, argv in (("bench_416", ["--paths", ",".join(bench_416.PATHS)]),
                          ("bench_416_pc", ["--paths", ",".join(bench_416.PATHS),
                                            "--set", "QUANT_PER_CHANNEL_ACT=True"]),
                          ("bench_416_fpn", ["--backbone", "resnet50_fpn", "--paths", "int8"])):
            args = tool_args(bench_416, "--batch", M1_BATCH, *argv)
            pcfg = bench_416.run_config(args)
            drive(tag, lambda: bench_416.run(pcfg, args), ("crop_rois",))
            if tag == "bench_416_fpn":
                continue
            pmodel = model if tag == "bench_416" else _timing.seeded_model(pcfg, args)
            pdet = det if tag == "bench_416" else _timing.quantized(pmodel, pcfg, dev)
            for path in bench_416.PATHS:
                fn = bench_416.path_fn(path, pmodel, pdet, pcfg)
                if path in bench_416.DETECT:
                    fused_mask, fused_ds = bench_416.DETECT[path]
                    lib = (lambda fm=fused_mask, fd=fused_ds:
                           pdet.detect_outputs(images, fused_mask=fm, fused_ds=fd))
                elif path == "infer_yolo":
                    lib = lambda: infer_yolo_outputs(pmodel.net, images, pcfg)   # noqa: E731
                else:
                    lib = lambda: pdet.infer_yolo_outputs(images)                # noqa: E731
                per_call[f"{tag}:{path}"] = same_call(f"{tag} {path}", lambda fn=fn: fn(images),
                                                      lib)
        expect_counts("bench_416 fused_both", per_call["bench_416:fused_both"],
                      {k: q2_pt[k] for k in ("fused_ds_block", "fused_mask_branch")})
        expect_counts("bench_416 int8", per_call["bench_416:int8"],
                      {"crop_rois": 1, "fused_ds_block": 0, "fused_mask_branch": 0})
        del model, det, images
        torch.cuda.empty_cache()

        # (7) bench_export: the artifact against live, bit for bit
        args = tool_args(bench_export, "--config", "coco416", "--batch", M1_BATCH)
        rows = drive("bench_export",
                     lambda: bench_export.run(bench_export.run_config(args), args),
                     ("crop_rois",))
        if not all(r["outputs_equal"] for r in rows) or [r["compute_path"] for r in rows] != [
                "bfloat16", "int8"]:
            raise AssertionError(f"bench_export: artifact and live differ: {rows}")

    # (8) bench_train: bf16 at torch's defaults, f32 with TF32 off, then on
    for tag, dtype, tf32 in (("bench_train_bf16", "bfloat16", None),
                             ("bench_train_f32", "float32", "off"),
                             ("bench_train_f32_tf32", "float32", "on")):
        argv = ["--images", M1_TRAIN_IMAGES, "--compute-dtype", dtype]
        args = tool_args(bench_train, *argv, *(["--tf32", tf32] if tf32 else []))
        with TorchDefaults():
            drive(tag, lambda: bench_train.run(bench_train.run_config(args), args),
                  ("crop_rois", "crop_rois_backward"))

    # (9) ab_infer_yolo_exactness on an 8-image DenseShapes COCO directory
    cfg = Coco416Config()
    data_dir = workdir / "coco_ab"
    quality_run_coco._make_coco_copy(str(data_dir), M1_AB_IMAGES, 3, 80)
    spread_scores(MaskYOLO("inference", cfg, seed=SEED, device=dev)).save_weights(
        str(workdir / "ab_weights.pt"))
    args = tool_args(ab_infer_yolo_exactness, "--weights", workdir / "ab_weights.pt",
                     "--data", data_dir, "--limit", M1_AB_IMAGES)
    with TorchDefaults():
        report = run_main_path(lambda: ab_infer_yolo_exactness.run(
            ab_infer_yolo_exactness.run_config(args), args), counts.setdefault(
                "ab_infer_yolo_exactness", {}), expect=())
    if report["n_images"] != M1_AB_IMAGES or not all(
            isinstance(report[k], dict) for k in ("k32", "k48", "k64", "topn256")):
        raise AssertionError(f"ab_infer_yolo_exactness: {report}")
    out["ab_infer_yolo_exactness"] = [report]
    seconds = time.perf_counter() - t_start
    log(f"[tools] M1: every tool's rows held, outputs bit-equal to the library calls, launches "
        f"a call {per_call}; {seconds:.1f} s on {smi}")
    return {"summary": tools_summary(out), "launches_per_call": per_call,
            "infer_yolo_split": infer_split, "seconds": seconds}


def tools_summary(rows):
    """M1's numbers for the JSON line (every row is printed as it is made)."""
    def pick(r, *keys):
        return {k: r[k] for k in keys if k in r}

    out = {}
    for name, rs in rows.items():
        if name.startswith(("profile_stages", "profile_infer")):
            out[name] = {r["stage"]: pick(r, "ms", "us_per_img", "device_busy_share") for r in rs}
        elif name.startswith("bench_416"):
            out[name] = {r["path"]: pick(r, "ms", "img_per_s", "device_busy_share") for r in rs}
        elif name == "bench_roofline":
            out[name] = {r.get("dtype", r.get("probe")): r.get("tops", r.get("gbps")) for r in rs}
        elif name == "bench_export":
            out[name] = {r["flavor"]: pick(r, "live_ms", "artifact_ms", "artifact_vs_live")
                         for r in rs}
        elif name.startswith("bench_train"):
            out[name] = pick(rs[0], "step_ms", "device_only_images_per_sec", "device_busy_share",
                             "e2e_images_per_sec", "mb_per_step", "tf32")
        elif name == "profile_layers_416":
            layers = sorted((r for r in rs if "kind" in r), key=lambda r: -r["us_per_img"])
            out[name] = {"whole": pick(rs[-1], "us_per_img", "sum_isolated_us_per_img"),
                         "slowest": [pick(r, "layer", "us_per_img", "pct_of_gemm")
                                     for r in layers[:5]]}
        else:
            out[name] = rs[0]
    return out


def shapes_dataset_images(count, seed):
    ds = shapes_dataset(count, seed, ShapesConfig())
    return [ds.load_image(i) for i in ds.image_ids]



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
    ap.add_argument("--int8-quality", action="store_true",
                    help="instead of the phases: train CocoStyleConfig on DenseShapes (300 "
                         "images, 25 epochs) and print held-out box and mask AP in f32 weights "
                         "and in four int8 forms")
    ap.add_argument("--train-images", type=int, default=300,
                    help="--int8-quality: DenseShapes images to train on")
    ap.add_argument("--epochs", type=int, default=25, help="--int8-quality: epochs to train")
    ap.add_argument("--shapes-quality", action="store_true",
                    help="instead of the phases: train Shapes for 40 epochs on 400 images "
                         "in f32 and in bf16 and print held-out box and mask AP")
    ap.add_argument("--fpn-quality", action="store_true",
                    help="instead of the phases: train Shapes on the ResNet-50 + FPN backbone "
                         "in bf16 for 40 epochs on 400 images and print held-out box and mask "
                         "AP, float and int8 hybrid")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="--shapes-quality, --fpn-quality: the seeds to train at, one run a "
                         "seed (and dtype)")
    ap.add_argument("--child", nargs=2, metavar=("KIND", "DIR"), default=None,
                    help="internal: one process of phase X1, P1 or F1 (export, nccl, dp, tp, "
                         "export_fpn)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.child:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        kind, workdir = args.child[0], Path(args.child[1])
        result = CHILDREN[kind](dev, workdir)
        rank = os.environ.get("MYOLO_PROCESS_ID", "0")
        (workdir / f"{kind}{rank}.json").write_text(json.dumps(result))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); TF32 off for cuDNN and matmul")
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    if args.shapes_quality or args.int8_quality or args.fpn_quality:
        try:
            workdir.mkdir(parents=True)
            if args.int8_quality:
                int8_quality(dev, smi, workdir, args.train_images, args.epochs)
            elif args.fpn_quality:
                fpn_quality(dev, smi, workdir, args.seeds)
            else:
                shapes_quality(dev, smi, workdir, args.seeds)
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
    k3_vector = phase_k3_vector_scales(rng, dev, k3)
    int8_counts = {}
    phase_int8_slice(model8, model, cfg8, images, int8_counts)
    phase_serve(model8, cfg8, rng, int8_counts, n=16,
                expect=("fused_ds_block", "fused_mask_branch"), tag="serve int8")
    phase_int8_throughput(model8, cfg8, dev, rng, smi, bf16_ms, k1["b128"]["ms"],
                          k3["b128"]["ms"])
    export_dir = workdir.parent / "chip_smoke_export"
    shutil.rmtree(export_dir, ignore_errors=True)
    export_dir.mkdir(parents=True)
    try:
        exported, export_counts = phase_export(dev, smi, model, model8, export_dir)
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
    infer_counts = {}
    del model8
    torch.cuda.empty_cache()
    phase_infer_yolo(dev, rng, smi, cfg, cfg8, infer_counts)
    coco_counts = {}
    coco = phase_coco416(dev, smi, coco_counts)
    fpn_dir = workdir.parent / "chip_smoke_fpn"
    shutil.rmtree(fpn_dir, ignore_errors=True)
    fpn_dir.mkdir(parents=True)
    fpn_counts = {}
    try:
        fpn = phase_fpn(dev, smi, rng, new_crop, fpn_dir, fpn_counts)
    finally:
        shutil.rmtree(fpn_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    entry_dir = workdir.parent / "chip_smoke_entry"
    shutil.rmtree(entry_dir, ignore_errors=True)
    entry_dir.mkdir(parents=True)
    entry_counts = {}
    try:
        entry = phase_entry_points(dev, smi, entry_dir, entry_counts)
    finally:
        shutil.rmtree(entry_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    tools_dir = workdir.parent / "chip_smoke_tools"
    shutil.rmtree(tools_dir, ignore_errors=True)
    tools_dir.mkdir(parents=True)
    tools_counts = {}
    try:
        measured = phase_measurement_tools(dev, smi, tools_dir, tools_counts, coco_counts)
    finally:
        shutil.rmtree(tools_dir, ignore_errors=True)
    torch.cuda.empty_cache()

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
        del trained
        torch.cuda.empty_cache()
        shutil.rmtree(workdir)
        workdir.mkdir(parents=True)
        parallel, parallel_counts = phase_parallel(dev, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    g1_counts = {}
    graft = phase_graft_entry(dev, smi, g1_counts)

    def launches(name):
        return {path: sum(counts.get(name, [])) for path, counts in (
            ("float_detect", float_counts), ("int8_detect", int8_counts),
            ("infer_yolo", infer_counts), ("coco416", coco_counts), ("train", train_counts),
            ("train_bf16", train16_counts), ("data_evaluate", data_counts),
            ("c1_predict", entry_counts["float"]), ("c1_predict_int8", entry_counts["int8"]),
            *export_counts.items(), *parallel_counts.items(), *g1_counts.items(),
            *((f"m1_{tool}", c) for tool, c in tools_counts.items()))}

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

    def fpn_line(name, r, kernel, paths):
        """A row of K2 at one level of the pyramid: launches are the
        path's count of the wrapper over its 3 levels, a call launching each
        level once."""
        by_path = {path: sum(fpn_counts[path][kernel]) // 3 for path in paths}
        return kernel_line(name, "crop_rois.cu", "mask_yolo_tpu/ops/pallas_crop.py:92",
                           by_path, r["max_abs_err"], r["ms"], r["plain_ms"],
                           (r["bound_ms"], r["bound_by"]), library_ms=r["library_ms"],
                           at=r["at"], **({"cold_ms": r["cold_ms"]} if "cold_ms" in r else {}))

    fpn_rows = [fpn_line(f"crop_rois, FPN {tag[3:6]}² {tag[-2:]}", r, "crop_rois",
                         ("fpn_detect", "fpn_export", "fpn_int8") if tag.startswith("fpn416")
                         else ("fpn_train",))
                for tag, r in fpn["kernels"]["forward"].items()]
    fpn_rows += [fpn_line(f"crop_rois_backward, FPN 224² {lv}", r, "crop_rois_backward",
                          ("fpn_train",)) for lv, r in fpn["kernels"]["backward"].items()]
    print(json.dumps({"fpn": {key: fpn[key] for key in ("detect", "int8", "train", "export")},
                      "device": smi}))
    print(json.dumps({"export_parallel": {
        "export": {tag: {k: v for k, v in r.items() if k != "per_call"}
                   for tag, r in exported.items()},
        "parallel": parallel, "device": smi}}))
    print(json.dumps({"entry_points": entry, "device": smi}))
    print(json.dumps({"measurement_tools": measured, "device": smi}))
    print(json.dumps({"graft_entry": graft, "device": smi}))
    print(smi)
    print(json.dumps({"kernels": [
        crop_line("crop_rois", kernel.pop("detect"), kernel),
        crop_line("crop_rois_backward", kernel_bwd[0], {"coco416": kernel_bwd[1]},
                  paths=("train", "data_evaluate", "nccl_train", "dp_train", "tp_train",
                         "g1_dryrun1_train", "g1_dryrun2_train")),
        # the bf16 gradient's kernel: the same wrapper, counted on the bf16 run
        crop_line("crop_rois_backward_bf16", kernel_bwd16[0], {"coco416": kernel_bwd16[1]},
                  counted="crop_rois_backward", paths=("train_bf16",)),
        kernel_line("fused_ds_block", "fused_ds_block.cu", "mask_yolo_tpu/ops/pallas_ds.py:92",
                    launches("fused_ds_block"), k1["max_abs_err"], k1["ms"], k1["plain_ms"],
                    (k1["bound_ms"], k1["bound_by"]), at="one trunk's 10 calls, B=16",
                    parent_ms=k1["parent_ms"], gemm_core_ms=k1["gemm_core_ms"],
                    b128=b128(k1["b128"]), coco416=b128(k1["416"])),
        kernel_line("fused_mask_branch", "fused_mask_branch.cu",
                    "mask_yolo_tpu/ops/pallas_mask.py:233", launches("fused_mask_branch"),
                    k3["max_abs_err"], k3["ms"], k3["plain_ms"], (k3["bound_ms"], k3["bound_by"]),
                    at="B=16, K=10, 28x28x256", parent_ms=k3.get("parent_ms"),
                    gemm_core_ms=k3["gemm_core_ms"], b128=b128(k3["b128"]),
                    coco416=b128(k3["416"])),
        # the same kernel on per-channel activation scales (Q1), launched by
        # the per-channel forms of the 416² slice (Q2: the last two int8 runs)
        kernel_line("fused_mask_branch, vector scales", "fused_mask_branch.cu",
                    "mask_yolo_tpu/ops/pallas_mask.py:233",
                    {"coco416_per_channel": sum(coco_counts["fused_mask_branch"][-2:])},
                    k3_vector["max_abs_err"], k3_vector["ms"], k3_vector["plain_ms"],
                    (k3_vector["bound_ms"], k3_vector["bound_by"]),
                    at="B=16, K=10, 28x28x256, per-channel scales + bias_corr",
                    gemm_core_ms=k3_vector["gemm_core_ms"], coco416=b128(k3_vector["416"]),
                    detect_batch_416_ms={tag: r["ms"] for tag, r in coco.items()}),
        *fpn_rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
