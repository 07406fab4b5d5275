"""Train / infer Mask-YOLO on the VIA-annotated Rice dataset — port of the
JAX package's `examples/rice/train_rice.py`, with the same flags.

--dataset is the dataset root (train/ and val/, each with a via_*.json);
`infer` draws each val image's detections into ./img_results/ (needs
matplotlib).

Run: python -m mask_yolo_tpu_torch.examples.rice.train_rice --dataset ./rice
"""

import argparse

from ...tools._common import add_device_flag, load_weights


def parser(name="rice", doc=__doc__):
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--dataset", required=True, help=f"{name} dataset root")
    ap.add_argument("--command", choices=["train", "infer"], default="train")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--model-dir", default=f"./checkpoints/{name}")
    add_device_flag(ap)
    return ap


def run_via(config, args, load):
    """Train on load("train") with load("val") for validation, or detect on
    load("val"); `load(subset)` returns a prepared VIA dataset. Returns the
    model (train) or each image's result (infer)."""
    from ... import MaskYOLO
    from ...data.loader import load_image_gt

    dataset_val = load("val")
    if args.command == "train":
        model = MaskYOLO(mode="training", config=config, model_dir=args.model_dir,
                         yolo_pretrain_dir=args.weights, device=args.device)
        model.train(load("train"), dataset_val, learning_rate=config.LEARNING_RATE,
                    epochs=args.epochs, layers="all")
        return model
    model = MaskYOLO(mode="inference", config=config, device=args.device)
    load_weights(model, args.weights)
    out = []
    for image_id in dataset_val.image_ids:
        image, _, _, _ = load_image_gt(dataset_val, config, image_id)
        out.append(model.detect(image)[0])
    return out


def run(config, args):
    from ...data.via import RiceDataset

    def load(subset):
        ds = RiceDataset()
        ds.load_rice(args.dataset, subset)
        ds.prepare()
        return ds

    return run_via(config, args, load)


def main(argv=None):
    from ...data.via import RiceConfig

    args = parser().parse_args(argv)
    config = RiceConfig()
    config.display()
    return run(config, args)


if __name__ == "__main__":
    main()
