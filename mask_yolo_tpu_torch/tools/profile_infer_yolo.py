"""Stage-level timing of the int8 infer_yolo pipeline at the 416², 81-class
point (CocoStyleConfig) — port of the JAX package's
`tools/profile_infer_yolo.py`, with its flags and JSON lines.

Prefixes of `pipelines.infer_yolo_from_callables` on the int8 trunk,
composed as the JAX tool composes them (its `:94-150`):

  trunk     int8 backbone + neck + YOLO head (grid)
  +decode   + proposal decode, sigmoid confidence, the reference's softmax
            (shifted by each image's maximum), the OBJ_THRESHOLD cut
  +select   + candidate compaction: each class's top INFER_YOLO_PER_CLASS_K
            boxes when that is set, else the INFER_YOLO_TOP_N boxes with
            the highest class probability, else the whole grid
  +nms      + the greedy per-class suppression (`ops.nms.greedy_keep`: one
            chain for all images and classes, launched once a step from
            the host, so its wall time is mostly host time; the row's
            device_busy_share says how much)
  full      QuantizedDetector.infer_yolo_fn(): + scatter-back, each box's
            winning class, validity (= infer_yolo_outputs)

Weights: MaskYOLO("inference", seed=0) or --weights, quantized on 4 noise
images of RandomState(1); input [batch, 416, 416, 3] float noise from
RandomState(0). At seeded weights few boxes pass OBJ_THRESHOLD, and that
count sets the NMS chain's length: it goes to stderr (boxes over the
threshold a class and image, and the chain's steps), so that a row can be
read. --trace-only runs each stage once, untimed, and checks its outputs
are finite (the JAX flag lowers them without running).

Run: python -m mask_yolo_tpu_torch.tools.profile_infer_yolo [--batch 128]
     [--per-class-k 48] [--top-n 256] [--stages a,b] [--end-to-end-only]
     [--trace-only] [--weights W] [--device cpu]
Prints one JSON line per stage; exits 1 if a stage failed.
"""

from __future__ import annotations

import argparse

from . import _timing
from .profile_stages_416 import bench_config, picked, stage_args

STAGE_NAMES = ("trunk", "+decode", "+select", "+nms", "full")


def run_config(args, base=None):
    """`base` (CocoStyleConfig) with --top-n / --per-class-k applied."""
    base = base or type(bench_config())
    fields = {}
    if args.top_n is not None:
        fields["INFER_YOLO_TOP_N"] = args.top_n
    if args.per_class_k is not None:
        fields["INFER_YOLO_PER_CLASS_K"] = args.per_class_k
    return type("Cfg", (base,), fields)()


def compaction(cfg):
    """(per-class K, shared top-N) in force: at most one is non-zero."""
    n_grid = cfg.GRID_H * cfg.GRID_W * cfg.N_BOX
    k_cls = int(cfg.INFER_YOLO_PER_CLASS_K or 0)
    n_top = int(cfg.INFER_YOLO_TOP_N or 0)
    if k_cls and k_cls < n_grid:
        return k_cls, 0
    return 0, (n_top if n_top and n_top < n_grid else 0)


def build_stages(det, cfg):
    """[(name, images → outputs)] of the five prefixes (module docstring)."""
    import torch

    from ..ops.boxes import decode_yolo_proposals
    from ..ops.nms import class_aware_nms, greedy_nms_mask, reference_softmax, stable_top_k
    from ..pipelines import _take

    k_cls, n_top = compaction(cfg)
    nms_t = float(cfg.NMS_THRESHOLD)

    def upto_decode(images):
        grid = det.trunk(images)[0].float()
        boxes = decode_yolo_proposals(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
        conf = torch.sigmoid(grid[..., 4])
        probs = conf[..., None] * reference_softmax(grid[..., 5:], batch_dims=1)
        probs = probs * (probs > cfg.OBJ_THRESHOLD)
        return boxes, probs.reshape(grid.shape[0], -1, cfg.NUM_CLASSES)

    def upto_select(images):
        boxes, probs = upto_decode(images)
        if k_cls:   # each class's own top-K: boxes [B, C, K, 4], scores [B, C, K]
            top_s, top_i = stable_top_k(probs.transpose(1, 2), k_cls)
            b, c = top_i.shape[:2]
            own = torch.gather(boxes[:, None].expand(b, c, -1, 4), 2,
                               top_i[..., None].expand(b, c, k_cls, 4))
            return own, top_s
        if n_top:
            _, idx = stable_top_k(probs.amax(dim=-1), n_top)
            return _take(boxes, idx), _take(probs, idx)
        return boxes, probs

    def upto_nms(images):
        bx, sc = upto_select(images)
        if k_cls:
            return sc * greedy_nms_mask(bx, sc, nms_t).to(sc.dtype)
        return class_aware_nms(bx, sc, nms_t)

    return list(zip(STAGE_NAMES, (lambda images: det.trunk(images), upto_decode, upto_select,
                                  upto_nms, det.infer_yolo_fn())))


def candidates_note(cfg):
    """stderr line for the NMS-bearing stages: boxes over OBJ_THRESHOLD a
    class and image (the NMS's work) and the chain's length."""
    def note(name, out):
        from ..ops.nms import greedy_keep

        if name == "+decode":
            live = (out[1] > 0).sum(1)                       # [B, C]
            return (f"{int(live.sum())} (box, class) pairs over OBJ_THRESHOLD "
                    f"{cfg.OBJ_THRESHOLD}; max {int(live.max())} a class and image")
        if name in ("+nms", "full"):
            return f"the NMS chain ran {greedy_keep.steps} steps"
        return None
    return note


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    stage_args(ap)
    _timing.add_weights_flag(ap)
    ap.add_argument("--top-n", type=int, default=None,
                    help="override INFER_YOLO_TOP_N (CocoStyle default 256)")
    ap.add_argument("--per-class-k", type=int, default=None,
                    help="override INFER_YOLO_PER_CLASS_K (default 0 = off)")
    ap.add_argument("--end-to-end-only", action="store_true",
                    help="time only the full shipped pipeline (fast A/B mode)")
    ap.add_argument("--trace-only", action="store_true",
                    help="run each stage once, untimed, and check its outputs are finite "
                         "(a shape/type smoke test)")
    return ap


def trace_rows(stages, images):
    import torch

    rows = []
    for name, fn in stages:
        try:
            with torch.inference_mode():
                out = fn(images)
            leaves = out.values() if isinstance(out, dict) else (
                out if isinstance(out, (tuple, list)) else (out,))
            if not all(torch.isfinite(t.float()).all() for t in leaves):
                raise FloatingPointError("non-finite output")
            rows.append(_timing.emit({"stage": name, "traced": True}))
        except Exception as e:   # noqa: BLE001 - the JAX tools' error line
            rows.append(_timing.error_row({"stage": name}, e))
    return rows


def run(config, args):
    """One row a stage of `config`'s int8 infer_yolo."""
    model = _timing.seeded_model(config, args)
    det = _timing.quantized(model, config, model.device)
    stages = build_stages(det, config)
    stages = stages[-1:] if args.end_to_end_only else picked(stages, args.stages)
    images = _timing.seeded_images(args.batch, config.IMAGE_SHAPE, model.device)
    if args.trace_only:
        return trace_rows(stages, images)
    return _timing.stage_rows(stages, images, model.device, note=candidates_note(config),
                              extra={"top_n": int(config.INFER_YOLO_TOP_N or 0),
                                     "per_class_k": int(config.INFER_YOLO_PER_CLASS_K or 0)})


def main(argv=None):
    args = parser().parse_args(argv)
    return _timing.finish(run(run_config(args), args))


if __name__ == "__main__":
    main()
