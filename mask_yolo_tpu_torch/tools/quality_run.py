"""Quality run: train Mask-YOLO on Shapes, then report box/mask AP, the
int8 path's AP on the same weights, and save overlays — port of the JAX
package's `tools/quality_run.py`, with the same flags and metrics.json keys.

Run: python -m mask_yolo_tpu_torch.tools.quality_run --epochs 40 --train-images 400
Outputs under --out (default ./quality_run/): weights, metrics.json,
InferMaskYOLO-*.png overlays (need matplotlib; --num-overlays 0 draws none).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ._common import add_device_flag


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-images", type=int, default=400)
    ap.add_argument("--val-images", type=int, default=50)
    ap.add_argument("--eval-images", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="./quality_run")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override Config.COMPUTE_DTYPE for the run")
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"],
                    help="override Config.BACKBONE (resnet50_fpn = the "
                         "reference README's stated scale-up path)")
    ap.add_argument("--augment", action="store_true",
                    help="seeded per-epoch flip/rot90/scale/brightness "
                         "augmentation (data/augment.default_augmenter)")
    ap.add_argument("--augment-flip-only", action="store_true",
                    help="flip-only augmentation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-overlays", type=int, default=4)
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="Config.LR_SCHEDULE for the run")
    ap.add_argument("--lr-warmup-steps", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate pooled AP on the eval set every N epochs "
                         "during training (make_ap_eval_callback); tracks "
                         "the best box_ap50 checkpoint")
    add_device_flag(ap)
    return ap


def run_config(args, base=None):
    """`base` (default ShapesConfig) with the run's batch size, LR schedule,
    compute dtype and backbone."""
    if base is None:
        from ..data.shapes import ShapesConfig as base
    fields = {"BATCH_SIZE": args.batch_size, "LR_SCHEDULE": args.lr_schedule,
              "LR_WARMUP_STEPS": args.lr_warmup_steps}
    if args.compute_dtype:
        fields["COMPUTE_DTYPE"] = args.compute_dtype
    if args.backbone:
        fields["BACKBONE"] = args.backbone
    return type("RunConfig", (base,), fields)()


def augmenter(args):
    """The augmentation of --augment-flip-only / --augment, or None."""
    from ..data import augment

    if args.augment_flip_only:
        return augment.Sequential([augment.Fliplr(0.5)], seed=args.seed + 7)
    if args.augment:
        return augment.default_augmenter(seed=args.seed + 7)
    return None


def int8_calibration(dataset, config, image_ids):
    """The images `image_ids` of `dataset` as the loader gives them, float
    in [0, 1]: the int8 path's calibration batch."""
    from ..data.loader import load_image_gt

    return np.stack([load_image_gt(dataset, config, i)[0].astype(np.float32) / 255.0
                     for i in image_ids])


def ap_trajectory(ap_cb):
    return {"best_epoch_box_ap50": ap_cb.best,
            "ap_trajectory": [{k: e[k] for k in ("epoch", "box_ap50", "mask_ap50")}
                              for e in ap_cb.history]}


def run(config, args):
    """Train, evaluate in f32 weights and int8, write metrics.json and the
    overlays into args.out. Returns the metrics."""
    from .. import MaskYOLO, evaluate_dataset, make_ap_eval_callback
    from ..data.shapes import ShapesDataset

    os.makedirs(args.out, exist_ok=True)
    h, w = config.IMAGE_SHAPE[:2]
    train_ds, val_ds, eval_ds = ShapesDataset(), ShapesDataset(), ShapesDataset()
    for i, (ds, count) in enumerate(((train_ds, args.train_images), (val_ds, args.val_images),
                                     (eval_ds, args.eval_images))):
        ds.load_shapes(count, h, w, seed=args.seed + i)
        ds.prepare()

    callbacks = None
    ap_cb = None
    if args.eval_every > 0:
        ap_cb = make_ap_eval_callback(
            eval_ds, config, every=args.eval_every, batch_size=8,
            score_threshold=args.score_threshold,
            history_path=os.path.join(args.out, "ap_history.jsonl"),
            best_weights_path=os.path.join(args.out, "best_weights"))
        callbacks = [ap_cb]

    model = MaskYOLO(mode="training", config=config,
                     model_dir=os.path.join(args.out, "ckpt"), seed=args.seed,
                     device=args.device)
    t0 = time.perf_counter()
    model.train(train_ds, val_ds, learning_rate=args.lr, epochs=args.epochs,
                layers="all", augmentation=augmenter(args),
                custom_callbacks=callbacks)
    train_s = time.perf_counter() - t0
    weights = os.path.join(args.out, "weights")
    model.save_weights(weights)
    print(f"trained {args.epochs} epochs in {train_s:.0f}s", flush=True)

    infer = MaskYOLO(mode="inference", config=type(config)(), device=args.device)
    infer.load_weights(weights)

    t0 = time.perf_counter()
    result = evaluate_dataset(infer, eval_ds, config, batch_size=8,
                              score_threshold=args.score_threshold)
    eval_s = time.perf_counter() - t0
    result.pop("per_image")

    # the int8 path's accuracy on the same weights (PTQ calibrated on a few
    # eval images): what quantization costs
    quantized = MaskYOLO(mode="inference", config=type(config)(), device=args.device)
    quantized.load_weights(weights)
    quantized.quantize(int8_calibration(eval_ds, config, list(eval_ds.image_ids)[:8]))
    q_result = evaluate_dataset(quantized, eval_ds, config, batch_size=8,
                                score_threshold=args.score_threshold)
    result["int8_box_ap50"] = q_result["box_ap50"]
    result["int8_mask_ap50"] = q_result["mask_ap50"]
    result["int8_mean_recall50"] = q_result["mean_recall50"]
    result["train_seconds"] = round(train_s, 1)
    result["eval_seconds"] = round(eval_s, 1)
    result["epochs"] = args.epochs
    result["train_images"] = args.train_images
    if ap_cb is not None and ap_cb.history:
        result.update(ap_trajectory(ap_cb))
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2), flush=True)

    for image_id in list(eval_ds.image_ids)[:args.num_overlays]:
        infer.detect(eval_ds.load_image(image_id), save_path=args.out,
                     cs_threshold=args.score_threshold)
    if args.num_overlays:
        print("overlays saved to", args.out, flush=True)
    return result


def main(argv=None):
    args = parser().parse_args(argv)
    return run(run_config(args), args)


if __name__ == "__main__":
    main()
