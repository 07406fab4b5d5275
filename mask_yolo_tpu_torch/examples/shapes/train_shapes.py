"""Train Mask-YOLO on the synthetic Shapes dataset — port of the JAX
package's `examples/shapes/train_shapes.py`, with the same flags.

Build the Shapes train/val datasets, construct MaskYOLO in training (or
yolo) mode and train end to end; checkpoints and config.json go to
--model-dir.

Run: python -m mask_yolo_tpu_torch.examples.shapes.train_shapes --epochs 10
"""

import argparse

from ...tools._common import add_device_flag


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-images", type=int, default=500)
    ap.add_argument("--val-images", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--mode", choices=["training", "yolo"], default="training")
    ap.add_argument("--model-dir", default="./checkpoints/shapes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--augment", action="store_true",
                    help="seeded flip/rot90/scale/brightness augmentation "
                         "(data/augment.default_augmenter)")
    add_device_flag(ap)
    return ap


def run(config, args):
    """Train on Shapes images of config.IMAGE_SHAPE; returns the model."""
    from ... import MaskYOLO
    from ...data.shapes import ShapesDataset

    h, w = config.IMAGE_SHAPE[:2]
    dataset_train = ShapesDataset()
    dataset_train.load_shapes(args.train_images, h, w, seed=args.seed)
    dataset_train.prepare()

    dataset_val = ShapesDataset()
    dataset_val.load_shapes(args.val_images, h, w, seed=args.seed + 1)
    dataset_val.prepare()

    augmentation = None
    if args.augment:
        from ...data.augment import default_augmenter
        augmentation = default_augmenter(seed=args.seed)

    model = MaskYOLO(mode=args.mode, config=config, model_dir=args.model_dir,
                     seed=args.seed, device=args.device)
    model.train(dataset_train, dataset_val,
                learning_rate=args.lr or config.LEARNING_RATE,
                epochs=args.epochs, layers="all", augmentation=augmentation)
    return model


def main(argv=None):
    from ...data.shapes import ShapesConfig

    args = parser().parse_args(argv)
    config = ShapesConfig()
    config.display()
    return run(config, args)


if __name__ == "__main__":
    main()
