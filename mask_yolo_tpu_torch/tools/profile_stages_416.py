"""Stage-level timing of the int8 detect pipeline at the 416², 81-class
point (CocoStyleConfig) — port of the JAX package's
`tools/profile_stages_416.py`, with its flags and JSON lines.

Prefixes of `quant.QuantizedDetector`'s detect pipeline on the config's own
knobs (chained int8 layers unless QUANT_FUSED_DS / QUANT_FUSED_MASK say
otherwise), composed as the JAX tool composes them (its `:93-150`):

  trunk        int8 backbone + neck + YOLO head (grid, fmap)
  +decode_nms  + grid decode, zero-area filter, score top-K, the index-order
               class NMS at DETECTION_NMS_THRESHOLD, and the MASK_TOP_K
               valid-first re-sort
  +crop        + the crop of the MASK_TOP_K survivors from the bf16 fmap
               (`quant._crop`: K2 on the card, as the chained int8 mask
               branch runs it)
  +maskconvs   + the int8 mask conv stack (4 convs, deconv, class conv) on
               those crops
  +select      + the one-hot class select; this stage calls the detector's
               mask_branch (crop and convs again), as the JAX tool does
  full         QuantizedDetector.detect_fn(): + paste to 416², threshold,
               validity (the shipped pipeline, = detect_outputs)

Weights: MaskYOLO("inference", seed=0), quantized on 4 noise
images of RandomState(1); input [batch, 416, 416, 3] float noise from
RandomState(0). Timing: `_timing` (wall time and the device's busy share).
The top-K slots over OBJ_THRESHOLD go to stderr.

Run: python -m mask_yolo_tpu_torch.tools.profile_stages_416 [--batch 128]
     [--stages a,b] [--device cpu]
Prints one JSON line per stage; exits 1 if a stage failed.
"""

from __future__ import annotations

import argparse

from . import _timing
from ._common import add_device_flag

STAGE_NAMES = ("trunk", "+decode_nms", "+crop", "+maskconvs", "+select", "full")


def bench_config():
    from ..config import CocoStyleConfig

    return CocoStyleConfig()


def upto_decode(det, cfg, images):
    """(fmap, boxes, scores, classes, valid) of the K slots after the NMS
    and, when MASK_TOP_K < K, the valid-first re-sort."""
    import torch

    from ..ops.boxes import decode_detections
    from ..ops.nms import index_order_class_nms_mask, stable_top_k
    from ..pipelines import _take

    k = cfg.DETECTION_MAX_INSTANCES
    grid, fmap = det.trunk(images)
    d = decode_detections(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
    boxes, scores, classes = d[..., :4], d[..., 4], d[..., 5].to(torch.int32)
    area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0
    top_scores, idx = stable_top_k(torch.where(area_ok, scores, -1.0), k)
    top_boxes, top_classes = _take(boxes, idx), _take(classes, idx)
    valid = top_scores > cfg.OBJ_THRESHOLD
    valid = valid & index_order_class_nms_mask(top_boxes, top_classes, valid,
                                               float(cfg.DETECTION_NMS_THRESHOLD))
    if mask_top_k(cfg) < k:
        _, order = stable_top_k(torch.where(valid, top_scores + 2.0, top_scores), k)
        top_boxes, top_scores = _take(top_boxes, order), _take(top_scores, order)
        top_classes, valid = _take(top_classes, order), _take(valid, order)
    return fmap, top_boxes, top_scores, top_classes, valid


def mask_top_k(cfg) -> int:
    k = cfg.DETECTION_MAX_INSTANCES
    return min(int(cfg.MASK_TOP_K or 0) or k, k)


def build_stages(det, cfg):
    """[(name, images → outputs)] of the six prefixes (module docstring)."""
    import torch

    from .. import quant

    kp, pool = mask_top_k(cfg), cfg.MASK_POOL_SIZE
    hw = tuple(cfg.IMAGE_SHAPE[:2])

    def crop(fmap, boxes):
        return quant._crop(fmap.to(torch.bfloat16), boxes[:, :kp], pool, hw, kernel=True)

    def stage_trunk(images):
        return det.trunk(images)

    def stage_decode(images):
        return upto_decode(det, cfg, images)[1:]

    def stage_crop(images):
        fmap, b, s, _, v = upto_decode(det, cfg, images)
        return crop(fmap, b), s, v

    def stage_maskconvs(images):
        fmap, b, s, _, v = upto_decode(det, cfg, images)
        return quant.run_layers(det.graph["mask"], crop(fmap, b), quant=True), s, v

    def stage_select(images):
        fmap, b, s, c, v = upto_decode(det, cfg, images)
        m = det.mask_branch(b[:, :kp].contiguous(), fmap)
        onehot = torch.nn.functional.one_hot(c[:, :kp].long(), cfg.NUM_CLASSES).to(m.dtype)
        return torch.einsum("bkhwc,bkc->bkhw", m, onehot), s, v

    return list(zip(STAGE_NAMES, (stage_trunk, stage_decode, stage_crop, stage_maskconvs,
                                  stage_select, det.detect_fn())))


def candidates_note(cfg):
    """stderr line for the NMS-bearing stages: top-K slots over
    OBJ_THRESHOLD before the NMS."""
    def note(name, out):
        if name not in ("+decode_nms", "full"):
            return None
        scores = out[1] if name == "+decode_nms" else out["scores"]
        over = (scores > cfg.OBJ_THRESHOLD).sum(-1)
        return (f"{int(over.sum())} of {scores.numel()} top-K slots over OBJ_THRESHOLD "
                f"{cfg.OBJ_THRESHOLD} (max {int(over.max())} an image)")
    return note


def stage_args(ap):
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--stages", default=None, help="comma-separated subset (default: all)")
    add_device_flag(ap)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    stage_args(ap)
    return ap


def picked(stages, wanted):
    if not wanted:
        return stages
    want = set(wanted.split(","))
    return [s for s in stages if s[0] in want]


def run(config, args):
    """One row a stage of `config`'s int8 detector (CocoStyleConfig by
    default)."""
    model = _timing.seeded_model(config, args)
    det = _timing.quantized(model, config, model.device)
    images = _timing.seeded_images(args.batch, config.IMAGE_SHAPE, model.device)
    return _timing.stage_rows(picked(build_stages(det, config), args.stages), images,
                              model.device, note=candidates_note(config))


def main(argv=None):
    return _timing.finish(run(bench_config(), parser().parse_args(argv)))


if __name__ == "__main__":
    main()
