"""80-class quality run at the CocoStyleConfig operating point (416², 81
classes, MASK_TOP_K) — port of the JAX package's `tools/quality_run_coco.py`,
with its flags (bar --scan-steps: the port has no scan-superbatch trainer)
and its metrics.json keys.

Pipeline (the COCO loader end to end):
  1. generate a dense multi-class synthetic dataset (data/dense_shapes.py:
     80 classes, up to 48 instances an image — past MASK_TOP_K);
  2. export it to an on-disk COCO-style dataset (images/*.png + COCO JSON
     with RLE segmentations, data/coco.dataset_to_coco_json);
  3. reload it through data/coco.CocoDataset: training and evaluation read
     only the COCO-format copy;
  4. train, evaluate pooled box/mask AP, evaluate the int8 PTQ path, save
     overlays + metrics.json.

Run: python -m mask_yolo_tpu_torch.tools.quality_run_coco --epochs 25 --train-images 300
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ._common import add_device_flag
from .quality_run import ap_trajectory, augmenter, int8_calibration

MODULE = "mask_yolo_tpu_torch.tools.quality_run_coco"


def _make_coco_copy(out_dir, count, seed, num_classes, textured=False, size=416):
    """Dense synthetic set (size² images) → on-disk COCO dataset →
    CocoDataset. Reuses an existing materialization (same parameters ⇒ same
    data) when present."""
    from ..data.coco import CocoDataset, dataset_to_coco_json
    from ..data.dense_shapes import DenseShapesDataset

    ann = os.path.join(out_dir, "instances.json")
    sidecar = os.path.join(out_dir, "materialize_meta.json")
    want = {"count": count, "seed": seed, "num_classes": num_classes,
            "textured": bool(textured)}
    if size != 416:   # the JAX package's sidecar has no size: 416² is implied
        want["size"] = size
    reuse = False
    if os.path.exists(ann):
        with open(ann) as f:
            meta = json.load(f)
        reuse = len(meta.get("images", [])) == count
        # the image count alone can't distinguish a flat materialization
        # from a textured one (or a different seed) at the same path — the
        # sidecar records the generation parameters and must match exactly
        if reuse and os.path.exists(sidecar):
            with open(sidecar) as f:
                reuse = json.load(f) == want
        elif reuse:
            print(f"[warn] {out_dir}: no materialize_meta.json sidecar; "
                  "regenerating to guarantee the requested parameters",
                  flush=True)
            reuse = False
    if not reuse:
        src = DenseShapesDataset()
        src.load_dense(count, size, size, seed=seed, num_classes=num_classes,
                       textured=textured)
        src.prepare()
        ann = dataset_to_coco_json(src, out_dir)
        with open(sidecar, "w") as f:
            json.dump(want, f)
    d = CocoDataset()
    d.load_coco(ann, os.path.join(out_dir, "images"))
    d.prepare()
    return d


def _newest_checkpoint(ckpt_dir):
    import glob

    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "saved_model_*")),
                   key=lambda p: p.rsplit("_e", 1)[-1])
    return ckpts[-1] if ckpts else None


def _resume_epoch(path):
    # saved_model_<time>_e<epoch>.pt
    return int(os.path.splitext(path.rsplit("_e", 1)[-1])[0]) if path else 0


def run_segmented(args, argv):
    """Supervisor: run training as child processes of --segment-epochs epochs
    each, chained by --resume-from, so that each process's host memory
    stays bounded on a long run. The schedules' horizon stays the full run
    because each child still receives --epochs; the final child (reaching
    --epochs) runs the evaluation."""
    ckpt_dir = os.path.join(args.out, "ckpt")
    resume = args.resume_from or _newest_checkpoint(ckpt_dir)
    done = _resume_epoch(resume)
    base = list(argv)
    # strip supervisor-only / per-segment args from the child command line
    for flag in ("--segment-epochs", "--stop-after-epoch", "--resume-from"):
        while flag in base:
            i = base.index(flag)
            del base[i:i + 2]
    while done < args.epochs:
        stop = min(done + args.segment_epochs, args.epochs)
        cmd = [sys.executable, "-m", MODULE, *base, "--stop-after-epoch", str(stop)]
        if resume:
            cmd += ["--resume-from", resume]
        print(f"[segment] epochs {done + 1}..{stop} of {args.epochs}"
              + (f" (resume {os.path.basename(resume)})" if resume else ""),
              flush=True)
        subprocess.run(cmd, check=True)
        resume = _newest_checkpoint(ckpt_dir)
        new_done = _resume_epoch(resume)
        if new_done <= done:
            raise RuntimeError(
                f"segment made no progress (epoch {done} -> {new_done})")
        done = new_done
    print("[segment] all segments complete", flush=True)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-images", type=int, default=300)
    ap.add_argument("--val-images", type=int, default=32)
    ap.add_argument("--eval-images", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="./quality_run_coco")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--textured", action="store_true",
                    help="photographic-complexity fixture: per-instance "
                         "texture, background clutter, lighting gradients "
                         "(data/dense_shapes.py textured mode)")
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--num-overlays", type=int, default=3)
    ap.add_argument("--mask-top-k", type=int, default=None,
                    help="override CocoStyleConfig.MASK_TOP_K for eval")
    ap.add_argument("--backbone", default=None,
                    choices=["mobilenet", "resnet50_fpn"],
                    help="override Config.BACKBONE (resnet50_fpn = the "
                         "reference README's stated scale-up path)")
    ap.add_argument("--augment", action="store_true",
                    help="per-epoch geometric + photometric train-time "
                         "augmentation (data/augment.default_augmenter)")
    ap.add_argument("--augment-flip-only", action="store_true",
                    help="flip-only augmentation (lighter; the Shapes "
                         "quality tool's recipe)")
    ap.add_argument("--skip-int8", action="store_true")
    ap.add_argument("--int8-per-channel", action="store_true",
                    help="QUANT_PER_CHANNEL_ACT for the int8 eval")
    ap.add_argument("--int8-qat-steps", type=int, default=0,
                    help="label-free QAT finetune steps for the int8 eval")
    ap.add_argument("--calib-images", type=int, default=8)
    ap.add_argument("--resume-from", default=None,
                    help="checkpoint from a previous run's ckpt/ — "
                         "continues training to --epochs total")
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="Config.LR_SCHEDULE for the run")
    ap.add_argument("--lr-warmup-steps", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate pooled AP on the eval set every N epochs "
                         "during training (make_ap_eval_callback); tracks "
                         "the best box_ap50 checkpoint")
    ap.add_argument("--segment-epochs", type=int, default=0,
                    help="run training as a chain of child processes of at "
                         "most N epochs each, resuming from the newest "
                         "checkpoint between them")
    ap.add_argument("--stop-after-epoch", type=int, default=0,
                    help="(internal/manual) stop this process's training "
                         "after epoch N; schedules still see --epochs")
    add_device_flag(ap)
    return ap


def run_config(args, base=None):
    """`base` (default CocoStyleConfig) with the run's classes, batch size,
    LR schedule, MASK_TOP_K and backbone."""
    if base is None:
        from ..config import CocoStyleConfig as base
    fields = {"BATCH_SIZE": args.batch_size, "NUM_CLASSES": 1 + args.num_classes,
              "LABELS": ["background"] + [f"c{i:02d}" for i in range(1, args.num_classes + 1)],
              "LR_SCHEDULE": args.lr_schedule, "LR_WARMUP_STEPS": args.lr_warmup_steps}
    if args.mask_top_k is not None:
        fields["MASK_TOP_K"] = args.mask_top_k
    if args.backbone:
        fields["BACKBONE"] = args.backbone
    return type("RunConfig", (base,), fields)()


def run(config, args):
    """Materialize the three COCO-format splits at config.IMAGE_SHAPE, train,
    evaluate (f32 weights and, unless --skip-int8, int8), write
    metrics.json and the overlays into args.out. Returns the metrics (None
    for a segment that stops before --epochs)."""
    from .. import MaskYOLO, evaluate_dataset, make_ap_eval_callback

    os.makedirs(args.out, exist_ok=True)
    size = config.IMAGE_SHAPE[0]
    print("materializing COCO-format datasets ...", flush=True)
    train_ds, val_ds, eval_ds = (
        _make_coco_copy(os.path.join(args.out, name), count, args.seed + i, args.num_classes,
                        textured=args.textured, size=size)
        for i, (name, count) in enumerate((("coco_train", args.train_images),
                                           ("coco_val", args.val_images),
                                           ("coco_eval", args.eval_images))))
    print(f"train={len(train_ds.image_ids)} val={len(val_ds.image_ids)} "
          f"eval={len(eval_ds.image_ids)} classes={train_ds.num_classes}",
          flush=True)

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
                resume_from=args.resume_from,
                custom_callbacks=callbacks,
                stop_after_epoch=args.stop_after_epoch or None)
    train_s = time.perf_counter() - t0
    if args.stop_after_epoch and args.stop_after_epoch < args.epochs:
        print(f"segment up to epoch {args.stop_after_epoch} done in "
              f"{train_s:.0f}s (of {args.epochs}); checkpoint on disk",
              flush=True)
        return None
    weights = os.path.join(args.out, "weights")
    model.save_weights(weights)
    print(f"trained {args.epochs} epochs in {train_s:.0f}s", flush=True)

    infer = MaskYOLO(mode="inference", config=type(config)(), device=args.device)
    infer.load_weights(weights)

    t0 = time.perf_counter()
    result = evaluate_dataset(infer, eval_ds, config, batch_size=8,
                              score_threshold=args.score_threshold)
    eval_s = time.perf_counter() - t0
    result.pop("per_image", None)

    if not args.skip_int8:
        qcfg = type(config)()
        if args.int8_per_channel:
            qcfg.QUANT_PER_CHANNEL_ACT = True
        quantized = MaskYOLO(mode="inference", config=qcfg, device=args.device)
        quantized.load_weights(weights)
        calib = int8_calibration(eval_ds, qcfg, list(eval_ds.image_ids)[:args.calib_images])
        quantized.quantize(calib, finetune_steps=args.int8_qat_steps, finetune_lr=1e-5)
        q = evaluate_dataset(quantized, eval_ds, qcfg, batch_size=8,
                             score_threshold=args.score_threshold)
        result["int8_box_ap50"] = q["box_ap50"]
        result["int8_mask_ap50"] = q["mask_ap50"]

    result["train_seconds"] = round(train_s, 1)
    result["eval_seconds"] = round(eval_s, 1)
    result["epochs"] = args.epochs
    result["train_images"] = args.train_images
    result["num_classes"] = args.num_classes
    result["mask_top_k"] = config.MASK_TOP_K
    result["textured"] = bool(args.textured)
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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if args.segment_epochs and not args.stop_after_epoch:
        return run_segmented(args, argv)
    return run(run_config(args), args)


if __name__ == "__main__":
    main()
