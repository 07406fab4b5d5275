"""Train / eval / infer Mask-YOLO on a COCO-JSON instance-segmentation
dataset (CocoStyleConfig) — port of the JAX package's
`examples/coco/train_coco.py`, with the same flags.

Layout expected:
    --train-ann path/to/instances_train.json  --train-images path/to/images
    --val-ann   path/to/instances_val.json    --val-images   path/to/images
`infer` draws the first 8 val images' detections into ./img_results/
(needs matplotlib).

Run: python -m mask_yolo_tpu_torch.examples.coco.train_coco --val-ann A --val-images D ...
"""

import argparse
import json

from ...tools._common import add_device_flag, load_weights


def load(ann, image_dir, class_ids=None):
    from ...data.coco import CocoDataset

    d = CocoDataset()
    d.load_coco(ann, image_dir, class_ids=class_ids)
    d.prepare()
    return d


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--command", choices=["train", "eval", "infer"],
                    default="train")
    ap.add_argument("--train-ann")
    ap.add_argument("--train-images")
    ap.add_argument("--val-ann", required=True)
    ap.add_argument("--val-images", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--model-dir", default="./checkpoints/coco")
    ap.add_argument("--class-ids", default=None,
                    help="comma-separated COCO category ids to restrict to")
    ap.add_argument("--score-threshold", type=float, default=0.35)
    add_device_flag(ap)
    return ap


def run_config(args, val_ds, base=None):
    """`base` (default CocoStyleConfig) with the batch size and the val
    set's classes."""
    if base is None:
        from ...config import CocoStyleConfig as base
    return type("RunConfig", (base,), {"BATCH_SIZE": args.batch_size,
                                       "NUM_CLASSES": val_ds.num_classes,
                                       "LABELS": list(val_ds.class_names)})()


def class_ids(args):
    return [int(c) for c in args.class_ids.split(",")] if args.class_ids else None


def run(config, args):
    """--command on the val set (and the train set); returns the model
    (train), the metrics (eval) or each image's result (infer)."""
    from ... import MaskYOLO

    val_ds = load(args.val_ann, args.val_images, class_ids(args))
    if args.command == "train":
        if not (args.train_ann and args.train_images):
            raise SystemExit("train needs --train-ann and --train-images")
        train_ds = load(args.train_ann, args.train_images, class_ids(args))
        model = MaskYOLO(mode="training", config=config,
                         model_dir=args.model_dir,
                         yolo_pretrain_dir=args.weights, device=args.device)
        model.train(train_ds, val_ds, learning_rate=config.LEARNING_RATE,
                    epochs=args.epochs, layers="all")
        return model
    model = MaskYOLO(mode="inference", config=config, device=args.device)
    load_weights(model, args.weights)
    if args.command == "eval":
        from ... import evaluate_dataset

        result = evaluate_dataset(model, val_ds, config, batch_size=8,
                                  score_threshold=args.score_threshold)
        result.pop("per_image", None)
        print(json.dumps(result, indent=2))
        return result
    from ...data.loader import load_image_gt

    out = []
    for image_id in list(val_ds.image_ids)[:8]:
        image, _, _, _ = load_image_gt(val_ds, config, image_id)
        out.append(model.detect(image, cs_threshold=args.score_threshold)[0])
    return out


def main(argv=None):
    args = parser().parse_args(argv)
    config = run_config(args, load(args.val_ann, args.val_images, class_ids(args)))
    config.display()
    return run(config, args)


if __name__ == "__main__":
    main()
