"""Stage-level timing of the float detect pipeline at the Shapes point
(ShapesConfig, 224², bf16) — port of the JAX package's
`tools/profile_stages.py`, with its positional arguments.

Each stage is a prefix of the pipeline, composed as the JAX tool composes
it (its `:68-110`), from the port's `MaskYoloNet.trunk` / `mask_branch`,
`ops.boxes.decode_detections` and `ops.nms.index_order_class_nms_mask`:

  trunk     backbone + YOLO head (grid, fmap)
  +decode   + grid decode to boxes/scores/classes
  +nms      + zero-area filter, score top-K, the index-order class NMS at
            0.7 (the JAX tool's constant, DETECTION_NMS_THRESHOLD's default)
  +mask     + the mask branch (crop through K2, mask convs) on the top-K
            boxes of +decode and the one-hot class select. This stage does
            NOT run +nms's NMS (nor the valid-first re-sort), as in the JAX
            tool: the prefixes are not strictly nested, so `delta_us` of
            +mask is not the mask branch's cost alone
  full      pipelines.detect_outputs (NMS, MASK_TOP_K re-sort, mask
            branch, paste to 224², threshold)

Weights: MaskYOLO("inference", seed=0). Input: [batch, 224,
224, 3] float noise from RandomState(0). Timing: `_timing.wall_ms`, wall
time of back-to-back calls closed by a synchronize, and the device's busy
share from torch.profiler (`_timing` docstring). The number of top-K slots
over OBJ_THRESHOLD, which sets the NMS's work, goes to stderr.

Run: python -m mask_yolo_tpu_torch.tools.profile_stages [batch] [stage ...]
     [--device cpu]
Prints one JSON line per stage; exits 1 if a stage failed.
"""

from __future__ import annotations

import argparse

from . import _timing
from ._common import add_device_flag

STAGE_NAMES = ("trunk", "+decode", "+nms", "+mask", "full")
NMS_T = 0.7   # the JAX tool's constant


def bench_config():
    from ..data.shapes import ShapesConfig

    return type("BenchConfig", (ShapesConfig,), {"COMPUTE_DTYPE": "bfloat16"})()


def top_k_slots(net, cfg, images):
    """trunk → decode → zero-area filter → score top-K: (boxes, scores,
    classes of the K slots, fmap)."""
    import torch

    from ..ops.boxes import decode_detections
    from ..ops.nms import stable_top_k
    from ..pipelines import _take

    grid, fmap = net.trunk(images)
    det = decode_detections(grid.float(), cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
    boxes, scores, classes = det[..., :4], det[..., 4], det[..., 5].to(torch.int32)
    area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0
    top_scores, idx = stable_top_k(torch.where(area_ok, scores, -1.0),
                                   cfg.DETECTION_MAX_INSTANCES)
    return _take(boxes, idx), top_scores, _take(classes, idx), fmap


def build_stages(net, cfg):
    """[(name, images → outputs)] of the five prefixes (module docstring)."""
    import torch

    from .. import pipelines
    from ..ops.boxes import decode_detections
    from ..ops.nms import index_order_class_nms_mask

    def stage_trunk(images):
        return net.trunk(images)

    def stage_decode(images):
        grid, fmap = net.trunk(images)
        return decode_detections(grid.float(), cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W), fmap

    def stage_nms(images):
        top_boxes, top_scores, top_classes, fmap = top_k_slots(net, cfg, images)
        valid = top_scores > cfg.OBJ_THRESHOLD
        keep = index_order_class_nms_mask(top_boxes, top_classes, valid, NMS_T)
        return top_boxes, top_scores, keep, fmap

    def stage_mask(images):
        top_boxes, top_scores, top_classes, fmap = top_k_slots(net, cfg, images)
        pred = net.mask_branch(top_boxes.contiguous(), fmap)          # [B, K, mh, mw, C]
        onehot = torch.nn.functional.one_hot(top_classes.long(), cfg.NUM_CLASSES).to(pred.dtype)
        return torch.einsum("bkhwc,bkc->bkhw", pred, onehot), top_scores

    def stage_full(images):
        return pipelines.detect_outputs(net, images, cfg)

    return list(zip(STAGE_NAMES, (stage_trunk, stage_decode, stage_nms, stage_mask,
                                  stage_full)))


def candidates_note(cfg):
    """stderr line for the NMS-bearing stages: top-K slots over
    OBJ_THRESHOLD (the work of the index-order NMS)."""
    def note(name, out):
        if name == "+nms":
            scores = out[1]
        elif name == "full":
            scores = out["scores"]
        else:
            return None
        over = (scores > cfg.OBJ_THRESHOLD).sum(-1)
        return (f"{int(over.sum())} of {scores.numel()} top-K slots over OBJ_THRESHOLD "
                f"{cfg.OBJ_THRESHOLD} (max {int(over.max())} an image)")
    return note


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("stages", nargs="*", metavar="stage",
                    help=f"a subset of {', '.join(STAGE_NAMES)} (default: all)")
    add_device_flag(ap)
    return ap


def run(config, args):
    """One row a stage of `config` (ShapesConfig bf16 by default)."""
    model = _timing.seeded_model(config, args)
    stages = build_stages(model.net, config)
    if args.stages:
        stages = [s for s in stages if s[0] in args.stages]
    images = _timing.seeded_images(args.batch, config.IMAGE_SHAPE, model.device)
    return _timing.stage_rows(stages, images, model.device, note=candidates_note(config))


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if set(args.stages) - set(STAGE_NAMES):
        ap.error(f"unknown stage(s) {sorted(set(args.stages) - set(STAGE_NAMES))}")
    return _timing.finish(run(bench_config(), args))


if __name__ == "__main__":
    main()
