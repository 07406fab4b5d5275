"""Benchmark: end-to-end detect throughput at 224² — port of the JAX
package's `bench.py`, at its operating point.

Measures the whole image → boxes + masks pipeline (backbone → YOLO head →
decode → NMS → top-K → ROI crop → mask head → mask paste) on the card, on a
batch that already lies there, and prints ONE JSON line:

  {"metric": ..., "value": N, "unit": "images/sec/chip", "batch_size": 128,
   "path": best, "per_path": {...}, "device": <card>, "timing": ...}

Operating point (the JAX bench's): ShapesConfig in bfloat16, batch 128,
seeded weights (`MaskYOLO("inference", seed=0)`), --backbone to swap the
trunk. Paths:
  bf16        pipelines.detect_outputs on the bf16 network (K2 crop);
  int8        QuantizedDetector.detect_outputs with the config's knobs
              (chained int8 layers), calibrated on 8 noise images;
  int8_fused  the same with QUANT_DW_INT8 + QUANT_FUSED_DS +
              QUANT_FUSED_MASK (K1 and K3), the JAX bench's fused=True.
A path the backbone cannot run is reported on stderr and left out.

Timing: the median over REPS reps of the wall time of ITERS back-to-back
calls, each rep closed by torch.cuda.synchronize(), after WARMUP calls.
Run: python -m mask_yolo_tpu_torch.bench [--backbone resnet50_fpn]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .tools import _timing
from .tools._common import add_device_flag

BATCH, WARMUP, ITERS, REPS = 128, 3, 10, 5
INT8_FUSED = {"QUANT_DW_INT8": True, "QUANT_FUSED_DS": True, "QUANT_FUSED_MASK": True}


def bench_config(backbone=None):
    from .data.shapes import ShapesConfig

    fields = {"COMPUTE_DTYPE": "bfloat16"}
    if backbone:
        fields["BACKBONE"] = backbone
    return type("BenchConfig", (ShapesConfig,), fields)()


def images_per_second(call, images, device) -> float:
    """The batch over the median wall time per call (module docstring)."""
    return images.shape[0] * 1e3 / _timing.wall_ms(lambda: call(images), device,
                                                    WARMUP, REPS, ITERS)


def run(config, args, batch_size=BATCH):
    """Time each path at `batch_size`; prints and returns the JSON
    result."""
    import torch

    from . import pipelines, weights
    from .model import MaskYOLO
    from .quant import QuantizedDetector

    model = MaskYOLO("inference", config, seed=0, device=args.device)
    device = model.device
    images = torch.as_tensor(np.random.RandomState(0).rand(
        batch_size, *config.IMAGE_SHAPE).astype(np.float32), device=device)
    calib = torch.as_tensor(np.random.RandomState(1).rand(
        8, *config.IMAGE_SHAPE).astype(np.float32), device=device)
    variables = weights.to_jax_variables(model._host_state)

    def int8(knobs):
        cfg = type("Int8BenchConfig", (type(config),), knobs)()
        det = QuantizedDetector.from_variables(variables, cfg, calib, device=device,
                                               net=model.net)
        return det.detect_outputs

    paths = {"bf16": lambda: lambda im: pipelines.detect_outputs(model.net, im, config),
             "int8": lambda: int8({}),
             "int8_fused": lambda: int8(INT8_FUSED)}
    per_path = {}
    with torch.inference_mode():
        for path, make in paths.items():
            try:
                call = make()
            except ValueError as e:   # a knob the backbone refuses (the FPN's K3)
                print(f"# {path}: not run: {e}", file=sys.stderr, flush=True)
                continue
            per_path[path] = images_per_second(call, images, device)
            print(f"# {path} batch {batch_size}: {per_path[path]:,.1f} img/s",
                  file=sys.stderr, flush=True)
    best = max(per_path, key=per_path.get)
    result = {
        "metric": "images/sec/chip end-to-end detect (224², boxes+masks on the card)",
        "value": round(per_path[best], 1),
        "unit": "images/sec/chip",
        "batch_size": batch_size,
        "path": best,
        "per_path": {k: round(v, 1) for k, v in per_path.items()},
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        "timing": (f"median over {REPS} reps of the wall time of {ITERS} back-to-back "
                   f"calls on a device-resident batch, each rep closed by "
                   f"torch.cuda.synchronize(), after {WARMUP} warm-up calls"),
    }
    if args.backbone:
        result["backbone"] = args.backbone
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(bench_config(args.backbone), args)


if __name__ == "__main__":
    main()
