"""Quantitative evaluation on Shapes: box/mask AP50, COCO mAP, recall —
port of the JAX package's `examples/shapes/eval_shapes.py`, with the same
flags. Runs the batched detect pipeline over a held-out Shapes set and
prints the numbers as JSON.

Run: python -m mask_yolo_tpu_torch.examples.shapes.eval_shapes --weights W
"""

import argparse
import json

from ...tools._common import add_device_flag, load_weights


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True,
                    help="checkpoint of MaskYOLO.save_weights / train, or a Keras .h5")
    ap.add_argument("--num-images", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--score-threshold", type=float, default=0.35)
    add_device_flag(ap)
    return ap


def run(config, args):
    """evaluate_dataset on --num-images seeded Shapes images; returns the
    metrics."""
    from ... import MaskYOLO, evaluate_dataset
    from ...data.shapes import ShapesDataset

    dataset = ShapesDataset()
    dataset.load_shapes(args.num_images, config.IMAGE_SHAPE[0],
                        config.IMAGE_SHAPE[1], seed=args.seed)
    dataset.prepare()

    model = MaskYOLO(mode="inference", config=config, device=args.device)
    load_weights(model, args.weights)
    result = evaluate_dataset(model, dataset, config,
                              batch_size=args.batch_size,
                              score_threshold=args.score_threshold,
                              verbose=True)
    result.pop("per_image")
    print(json.dumps(result, indent=2))
    return result


def main(argv=None):
    from ...data.shapes import ShapesConfig

    return run(ShapesConfig(), parser().parse_args(argv))


if __name__ == "__main__":
    main()
