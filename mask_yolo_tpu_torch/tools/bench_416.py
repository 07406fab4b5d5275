"""Throughput of the detect and infer_yolo paths at the 416², 81-class point
(CocoStyleConfig) — port of the JAX package's `tools/bench_416.py`, with
its flags, path names and JSON lines.

Paths (the JAX names, so that rows line up):
  int8             QuantizedDetector.detect_outputs(fused_mask=False,
                   fused_ds=False): chained int8 layers, the crop through K2
  fused_ds         + the stride-1 DS blocks as K1 (fused_ds=True)
  pallas_mask      + the mask branch as K3 (fused_mask=True); on the card
                   this is the Hopper kernel, not the Pallas one
  fused_both       K1 and K3
  infer_yolo       pipelines.infer_yolo_outputs on the float (bf16) network
  infer_yolo_int8  the same on the int8 trunk (QuantizedDetector.trunk)
--backbone resnet50_fpn makes the detector hybrid (float trunk, int8 mask
head): K3 takes one feature map, so pallas_mask and fused_both print their
error line there. --set KEY=VAL sets config attributes (VAL a Python
literal) before the model is built, e.g. --set QUANT_PER_CHANNEL_ACT=True.

Weights: MaskYOLO("inference", seed=0), quantized on 4 noise
images of RandomState(1); input [batch, 416, 416, 3] float noise from
RandomState(0). Timing: `_timing` (wall time of back-to-back calls, and the
device's busy share). A path that raises prints {"path", "error"} and the
tool exits 1 after the others.

Run: python -m mask_yolo_tpu_torch.tools.bench_416 [--batch 128]
     [--paths int8,fused_ds,pallas_mask] [--backbone resnet50_fpn]
     [--set KEY=VAL ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import ast
import sys

from . import _timing
from ._common import add_device_flag

PATHS = ("int8", "fused_ds", "pallas_mask", "fused_both", "infer_yolo", "infer_yolo_int8")
# detect paths: (fused_mask, fused_ds)
DETECT = {"int8": (False, False), "fused_ds": (False, True), "pallas_mask": (True, False),
          "fused_both": (True, True)}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--paths", default="int8,fused_ds,pallas_mask")
    ap.add_argument("--k-block", type=int, default=16,
                    help="accepted and ignored: the ROI block of the Pallas mask kernel "
                         "(a TPU tile size); the Hopper kernel K3 picks its own tiles")
    ap.add_argument("--backbone", default=None, choices=["mobilenet", "resnet50_fpn"],
                    help="override CocoStyleConfig.BACKBONE (resnet50_fpn = hybrid int8: "
                         "float trunk, int8 mask head)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                    help="config attribute overrides, VAL a Python literal")
    add_device_flag(ap)
    return ap


def overrides(args) -> dict:
    out = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        out[k] = ast.literal_eval(v)
    return out


def run_config(args, base=None):
    """`base` (CocoStyleConfig) with --backbone and --set applied."""
    if base is None:
        from ..config import CocoStyleConfig as base
    fields = dict(overrides(args))
    if args.backbone:
        fields["BACKBONE"] = args.backbone
    return type("Cfg", (base,), fields)()


def path_fn(path, model, det, cfg):
    """images → outputs of one path."""
    from .. import pipelines

    if path in DETECT:
        return det.detect_fn(*DETECT[path])   # K3 raises on a hybrid's pyramid
    if path == "infer_yolo":
        return lambda images: pipelines.infer_yolo_outputs(model.net, images, cfg)
    if path == "infer_yolo_int8":
        return lambda images: pipelines.infer_yolo_from_callables(det.trunk, images, cfg)
    raise ValueError(f"unknown path {path!r}")


def run(config, args):
    """One row a path of --paths."""
    import torch

    model = _timing.seeded_model(config, args)
    device = model.device
    det = _timing.quantized(model, config, device)
    images = _timing.seeded_images(args.batch, config.IMAGE_SHAPE, device)
    label = _timing.card(device)
    rows = []
    for path in args.paths.split(","):
        path = path.strip()
        if path not in PATHS:
            print(f"# unknown path {path}", file=sys.stderr)
            continue
        try:
            fn = path_fn(path, model, det, config)
            with torch.inference_mode():
                ms = _timing.wall_ms(lambda: fn(images), device)
                share = _timing.busy_share(lambda: fn(images), device, ms)
        except Exception as e:   # noqa: BLE001 - the JAX tool's error line
            rows.append(_timing.error_row({"path": path}, e))
            continue
        rows.append(_timing.emit({"path": path, "img_per_s": args.batch * 1e3 / ms,
                                  "batch": args.batch, "backbone": config.BACKBONE,
                                  **overrides(args), "ms": ms, "device_busy_share": share,
                                  "device": label}))
    return rows


def main(argv=None):
    args = parser().parse_args(argv)
    return _timing.finish(run(run_config(args), args))


if __name__ == "__main__":
    main()
