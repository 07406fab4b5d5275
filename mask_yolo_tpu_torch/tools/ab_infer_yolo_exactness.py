"""On-checkpoint exactness A/B for the infer_yolo candidate-compaction knobs
(INFER_YOLO_PER_CLASS_K / INFER_YOLO_TOP_N) against the exact full-grid
per-class NMS — port of the JAX package's `tools/ab_infer_yolo_exactness.py`,
with its flags and JSON.

Per-class compaction gives the full-grid result while every class has no
more boxes over OBJ_THRESHOLD than it keeps (tests of `ops/nms.py` and the
pipelines hold that). This tool measures whether that condition holds for a
trained checkpoint on real images, and by how much: the largest and the
99th-percentile count of boxes over the threshold per (image, class) (the
reference softmax shifted by the whole batch's maximum, as the JAX tool
computes it), then, for each variant, whether its scores, validity and
classes equal the full grid's. Pure computation: no timing.

Run:
  python -m mask_yolo_tpu_torch.tools.ab_infer_yolo_exactness \\
      --weights quality_run_coco/weights --data quality_run_coco/coco_eval
CPU smoke: add --cpu (the CPU, at most 4 images), or --device cpu.
Prints one JSON line for the condition, one a variant, and a last line
"FULL: {...}" with the whole report (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ._common import add_device_flag, load_weights


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True,
                    help="checkpoint of MaskYOLO.save_weights / train, or a Keras .h5")
    ap.add_argument("--data", required=True,
                    help="COCO-format dataset dir (instances.json + images/)")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--limit", type=int, default=64)
    ap.add_argument("--k", type=int, nargs="+", default=[32, 48, 64])
    ap.add_argument("--top-n", type=int, nargs="+", default=[256])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with at most 4 images (the JAX tool's smoke mode)")
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    return ap


def run_config(args, base=None):
    """`base` (CocoStyleConfig) with --num-classes foreground classes."""
    if base is None:
        from ..config import CocoStyleConfig as base
    return type("RunConfig", (base,), {
        "NUM_CLASSES": 1 + args.num_classes,
        "LABELS": ["background"] + [f"c{i:02d}" for i in range(1, args.num_classes + 1)]})()


def run(config, args):
    """The report dict (module docstring)."""
    import torch

    from ..data.coco import CocoDataset
    from ..data.loader import load_image_gt
    from ..model import MaskYOLO
    from ..ops.nms import reference_softmax
    from ..pipelines import infer_yolo_outputs

    if args.cpu:
        args.device, args.limit = "cpu", min(args.limit, 4)
    ds = CocoDataset()
    ds.load_coco(os.path.join(args.data, "instances.json"), os.path.join(args.data, "images"))
    ds.prepare()
    m = MaskYOLO("inference", config, device=args.device)
    load_weights(m, args.weights)
    m.net.eval()

    ids = list(ds.image_ids)[:args.limit]
    images = torch.as_tensor(np.stack([
        load_image_gt(ds, config, i)[0].astype(np.float32) / 255.0 for i in ids]),
        device=m.device)

    def variant(top_n, k_cls):
        cfg = type("KC", (type(config),), {"INFER_YOLO_TOP_N": top_n,
                                            "INFER_YOLO_PER_CLASS_K": k_cls})()
        with torch.inference_mode():
            out = infer_yolo_outputs(m.net, images, cfg)
        return {n: v.cpu().numpy() for n, v in out.items()}

    exact = variant(0, 0)   # full-grid per-class NMS: the ground truth

    with torch.inference_mode():
        grid = m.net.trunk(images)[0].float()
        conf = torch.sigmoid(grid[..., 4])
        probs = conf[..., None] * reference_softmax(grid[..., 5:])
        over = probs > config.OBJ_THRESHOLD
        counts = over.reshape(images.shape[0], -1, config.NUM_CLASSES).sum(1).cpu().numpy()
    report = {"n_images": len(ids),
              "max_boxes_per_class": int(counts.max()),
              "p99_boxes_per_class": float(np.percentile(counts, 99))}
    print(json.dumps({"condition": report}), flush=True)

    variants = ([(f"k{k}", 0, k) for k in args.k]
                + [(f"topn{n}", n, 0) for n in args.top_n])
    for name, top_n, k_cls in variants:
        got = variant(top_n, k_cls)
        kept = exact["valid"]
        row = {
            "scores_equal": bool(np.allclose(got["scores"], exact["scores"], atol=1e-6)),
            "valid_equal": bool((got["valid"] == exact["valid"]).all()),
            "classes_equal_on_valid": bool((got["classes"][kept]
                                            == exact["classes"][kept]).all()),
            "divergent_entries": int((~np.isclose(got["scores"], exact["scores"],
                                                  atol=1e-6)).sum()),
        }
        report[name] = row
        print(json.dumps({name: row}), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print("FULL:", json.dumps(report), flush=True)
    return report


def main(argv=None):
    args = parser().parse_args(argv)
    return run(run_config(args), args)


if __name__ == "__main__":
    main()
