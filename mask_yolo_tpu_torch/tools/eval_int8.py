"""Evaluate int8 PTQ/QAT variants of a saved checkpoint against its f32 AP —
port of the JAX package's `tools/eval_int8.py`, with the same flags,
variants and output.

The int8 tail of tools/quality_run_coco.py on its own, so that the
quantization ablation (per-tensor vs per-channel activation scales, with or
without label-free QAT) re-runs on any checkpoint without retraining.

Run:
  python -m mask_yolo_tpu_torch.tools.eval_int8 --weights quality_run_coco/weights \\
      --data quality_run_coco/coco_eval --variants f32 pc pc_qat \\
      --out coco80_int8.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ._common import add_device_flag, load_weights
from .quality_run import int8_calibration

VARIANTS = ("f32", "pt", "pc", "pt_qat", "pc_qat", "pc_qat_mw",
            "pc_f32deconv", "pc_f32tail", "pc_qat_mw_f32deconv")
# each int8 variant: (QUANT_PER_CHANNEL_ACT, QAT finetune, other config knobs)
INT8_VARIANTS = {
    "pt": (False, False, {}),
    "pc": (True, False, {}),
    "pt_qat": (False, True, {}),
    "pc_qat": (True, True, {}),
    # mask-weighted QAT distillation: the residual lives in the mask
    # branch, so its term weighs 4x in the finetune objective
    "pc_qat_mw": (True, True, {"QUANT_QAT_MASK_WEIGHT": 4.0}),
    # leave the mask deconv (the last conv before the class head) float
    "pc_f32deconv": (True, False, {"QUANT_MASK_F32_LAYERS": ("mask_deconv",)}),
    # leave the whole mask tail (conv4 + deconv) float
    "pc_f32tail": (True, False, {"QUANT_MASK_F32_LAYERS": ("mask_conv4", "mask_deconv")}),
    "pc_qat_mw_f32deconv": (True, True, {"QUANT_QAT_MASK_WEIGHT": 4.0,
                                         "QUANT_MASK_F32_LAYERS": ("mask_deconv",)}),
}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True,
                    help="checkpoint of MaskYOLO.save_weights / train, or a Keras .h5")
    ap.add_argument("--data", required=True,
                    help="COCO-format dataset dir (instances.json + images/)")
    ap.add_argument("--variants", nargs="+", default=["f32", "pt", "pc", "pc_qat"],
                    choices=list(VARIANTS) + ["none"],
                    help="pt=per-tensor PTQ, pc=+QUANT_PER_CHANNEL_ACT, "
                         "*_qat=+label-free finetune; none = skip (e.g. a "
                         "pure --mask-top-k sweep)")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--calib-images", type=int, default=16)
    ap.add_argument("--qat-steps", type=int, default=200)
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--eval-images", type=int, default=0,
                    help="cap eval to the first N images (0 = all)")
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"])
    ap.add_argument("--mask-top-k", type=int, nargs="+", default=None,
                    help="ALSO evaluate the f32 model at each MASK_TOP_K "
                         "value (0 = mask every kept detection, the "
                         "reference's behavior): prices the masks-for-top-K "
                         "fallback where scenes exceed K instances")
    ap.add_argument("--out", default=None, help="write results JSON here")
    add_device_flag(ap)
    return ap


def run_config(args, base=None):
    """`base` (default CocoStyleConfig) with the checkpoint's classes and
    backbone."""
    if base is None:
        from ..config import CocoStyleConfig as base
    fields = {"NUM_CLASSES": 1 + args.num_classes,
              "LABELS": ["background"] + [f"c{i:02d}" for i in range(1, args.num_classes + 1)]}
    if args.backbone:
        fields["BACKBONE"] = args.backbone
    return type("RunConfig", (base,), fields)()


def run(config, args):
    """Evaluate the f32 model and each variant on args.data; returns (and
    with --out writes) the results."""
    from .. import MaskYOLO, evaluate_dataset
    from ..data.coco import CocoDataset

    ds = CocoDataset()
    ds.load_coco(os.path.join(args.data, "instances.json"),
                 os.path.join(args.data, "images"))
    ds.prepare()
    image_ids = list(ds.image_ids)
    if args.eval_images:
        image_ids = image_ids[:args.eval_images]

    def model(cfg):
        m = MaskYOLO(mode="inference", config=cfg, device=args.device)
        load_weights(m, args.weights)
        return m

    infer = model(config)
    calib = int8_calibration(ds, config, image_ids[:args.calib_images])

    def quantized(name):
        per_channel, qat, overrides = INT8_VARIANTS[name]
        cfg = type(config)()
        cfg.QUANT_PER_CHANNEL_ACT = per_channel
        for k, v in overrides.items():
            setattr(cfg, k, v)
        m = model(cfg)
        m.quantize(calib, finetune_steps=args.qat_steps if qat else 0, finetune_lr=1e-5)
        return m

    results = {}
    for kp in (args.mask_top_k or []):
        m = model(type("KpConfig", (type(config),), {"MASK_TOP_K": kp})())
        t0 = time.perf_counter()
        r = evaluate_dataset(m, ds, m.config, image_ids=image_ids,
                             batch_size=args.batch_size,
                             score_threshold=args.score_threshold)
        r.pop("per_image", None)
        r["eval_seconds"] = round(time.perf_counter() - t0, 1)
        results[f"f32_topk{kp}"] = r
        print(f"[f32 MASK_TOP_K={kp}] box_ap50={r['box_ap50']:.4f} "
              f"mask_ap50={r['mask_ap50']:.4f} ({r['eval_seconds']}s)",
              flush=True)

    for name in args.variants:
        if name == "none":
            continue
        t0 = time.perf_counter()
        r = evaluate_dataset(infer if name == "f32" else quantized(name), ds, config,
                             image_ids=image_ids, batch_size=args.batch_size,
                             score_threshold=args.score_threshold)
        r.pop("per_image", None)
        r["eval_seconds"] = round(time.perf_counter() - t0, 1)
        results[name] = r
        print(f"[{name}] box_ap50={r['box_ap50']:.4f} "
              f"mask_ap50={r['mask_ap50']:.4f} ({r['eval_seconds']}s)",
              flush=True)

    meta = {"weights": args.weights, "data": args.data,
            "n_images": len(image_ids), "calib_images": args.calib_images,
            "qat_steps": args.qat_steps, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(meta, f, indent=2)
    print(json.dumps(meta, indent=2), flush=True)
    return meta


def main(argv=None):
    args = parser().parse_args(argv)
    return run(run_config(args), args)


if __name__ == "__main__":
    main()
