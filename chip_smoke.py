#!/usr/bin/env python3
"""Run the PyTorch port (`mask_yolo_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs CUDA and nvcc

Phases, each fatal on failure (nothing is caught):
  1. device      the card's name and power limit; TF32 off for f32 references
  2. build       the CUDA crop kernel from mask_yolo_tpu_torch/csrc
  3. kernel      crop kernel vs its plain PyTorch twin at the detect path's
                 shapes, f32 and bf16, with CUDA-event times of both
  4. slice       MaskYOLO.detect_batch at 224² (ShapesConfig widths) in bf16
                 and f32; the kernel's launches are counted, and the same
                 trunk outputs go through the plain-crop mask branch too
  5. serve       BatchingExecutor(batch_size=16) answers 24 requests
  6. throughput  detect_batch at batch 128 bf16, CUDA events (recorded only)

The last three lines are the `nvidia-smi` name/power-limit line, a JSON line
of kernels, and {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mask_yolo_tpu_torch import MaskYOLO
from mask_yolo_tpu_torch.data.shapes import ShapesConfig
from mask_yolo_tpu_torch.ops import _build
from mask_yolo_tpu_torch.ops.roi_align import crop_and_resize
from mask_yolo_tpu_torch.ops.roi_crop import crop_rois
from mask_yolo_tpu_torch.pipelines import detect_from_callables, images_f32
from mask_yolo_tpu_torch.serve import BatchingExecutor

SEED = 0
BATCH = 16
KERNEL_SHAPE = dict(b=16, h=28, w=28, c=256, k=10, pool=14)   # the detect path's crop
CROP_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}        # max|Δ| / max|plain|
MASK_AGREE = 0.995


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_kernel(dev, rng):
    """Crop kernel vs plain twin; returns {dtype: (max_abs_err, ms, plain_ms)}."""
    s = KERNEL_SHAPE
    fmap32 = torch.tensor(rng.standard_normal((s["b"], s["h"], s["w"], s["c"]),
                                              dtype=np.float32), device=dev)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        fmap = fmap32.to(dtype)
        for k in (s["k"], 7):   # the detect path's K, and a prime K
            boxes = torch.tensor(random_boxes(rng, s["b"], k), device=dev)
            got = crop_rois(fmap, boxes, s["pool"]).float()
            want = crop_and_resize(fmap, boxes, (s["pool"], s["pool"])).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ratio = err / want.abs().max().item()
            log(f"[kernel] {dtype} K={k}: max|kernel-plain| = {err:.3e}, "
                f"/ max|plain| = {ratio:.3e} (limit {CROP_TOL[dtype]})")
            if not (torch.isfinite(got).all() and ratio <= CROP_TOL[dtype]):
                raise AssertionError(f"crop kernel disagrees with its plain twin ({dtype}, K={k})")
            if k == s["k"]:
                results[dtype] = [err]
        boxes = torch.tensor(random_boxes(rng, s["b"], s["k"]), device=dev)
        kernel = lambda: crop_rois(fmap, boxes, s["pool"])                    # noqa: E731
        plain = lambda: crop_and_resize(fmap, boxes, (s["pool"], s["pool"]))  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"[kernel] {dtype} time at B=16, 28x28x256, K=10, P=14: kernel "
            f"{ms * 1e3:.1f} us ({k1 * 1e3:.1f}, {k2 * 1e3:.1f}), plain "
            f"{plain_ms * 1e3:.1f} us ({p1 * 1e3:.1f}, {p2 * 1e3:.1f})")
        results[dtype] += [ms, plain_ms]
    return results


def run_main_path(fn, counts):
    """Drive the main path with the launch count zeroed just before and read
    just after; every main-path run must launch the kernel."""
    crop_rois.launches = 0
    out = fn()
    torch.cuda.synchronize()
    if crop_rois.launches == 0:
        raise AssertionError("the main path did not launch the crop kernel")
    counts.append(crop_rois.launches)
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
        f"{agree:.6f} of pixels (limit {MASK_AGREE}); crop launches {counts[-1]}")
    if agree < MASK_AGREE:
        raise AssertionError("masks disagree between kernel and plain crop")
    return model, cfg


def phase_serve(model, cfg, rng, counts):
    ex = BatchingExecutor(model, cfg, batch_size=BATCH)
    try:
        ex.warmup(timeout=300)
        images = (rng.random((24, *cfg.IMAGE_SHAPE)) * 255).astype(np.uint8)

        def serve():
            futs = [ex.submit(im, include_masks=i % 3 == 0) for i, im in enumerate(images)]
            return [f.result(timeout=300) for f in futs]

        results = run_main_path(serve, counts)
    finally:
        ex.shutdown()
    if len(results) != 24 or ex.stats["batches"] < 2:
        raise AssertionError(f"served {len(results)} requests in {ex.stats['batches']} batches")
    lat = ex.latency_ms
    n_masks = sum("mask_rle" in d for r in results for d in r["detections"])
    log(f"[serve] 24 requests answered, stats {ex.stats}, {n_masks} RLE masks; latency "
        f"p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms over {lat['n']} requests")


def phase_throughput(model, cfg, dev, rng, smi):
    images = torch.as_tensor((rng.random((128, *cfg.IMAGE_SHAPE)) * 255).astype(np.uint8),
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: model.detect_batch(images), iters=10, warmup=3)
    log(f"[throughput] detect_batch B=128 bf16 (uint8 input on device): {ms:.3f} ms/batch, "
        f"{128e3 / ms:.1f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB on {smi} (recorded, not claimed)")


def main() -> int:
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

    t0 = time.perf_counter()
    lib = _build.build("crop_rois")
    _build.load("crop_rois")
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s; nvcc: "
        + lib.with_suffix(".log").read_text().strip().replace("\n", " | "))

    rng = np.random.default_rng(SEED)
    kernel = phase_kernel(dev, rng)

    images = (rng.random((BATCH, *ShapesConfig.IMAGE_SHAPE)) * 255).astype(np.uint8)
    counts = []
    model, cfg = phase_slice("bfloat16", dev, images, counts)
    phase_slice("float32", dev, images, counts)
    phase_serve(model, cfg, rng, counts)
    phase_throughput(model, cfg, dev, rng, smi)

    err, ms, plain_ms = kernel[torch.bfloat16]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "crop_rois", "route": "cuda",
        "source": "mask_yolo_tpu_torch/csrc/crop_rois.cu",
        "replaces": "mask_yolo_tpu/ops/pallas_crop.py:92",
        "launches": sum(counts), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
