"""Run the whole detection + mask pipeline on Shapes images — port of the
JAX package's `examples/shapes/infer_shapes.py`, with the same flags. Each
image's overlay is drawn into --save-path (needs matplotlib).

Run: python -m mask_yolo_tpu_torch.examples.shapes.infer_shapes --weights W
"""

import argparse

from ...tools._common import add_device_flag, load_weights


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True,
                    help="checkpoint of MaskYOLO.save_weights / train, or a Keras .h5")
    ap.add_argument("--num-images", type=int, default=4)
    ap.add_argument("--save-path", default="./img_results/")
    ap.add_argument("--seed", type=int, default=123)
    add_device_flag(ap)
    return ap


def run(config, args):
    """Detect on --num-images seeded Shapes images; returns each image's
    result dict."""
    from ... import MaskYOLO
    from ...data.shapes import ShapesDataset

    dataset = ShapesDataset()
    dataset.load_shapes(args.num_images, config.IMAGE_SHAPE[0],
                        config.IMAGE_SHAPE[1], seed=args.seed)
    dataset.prepare()

    model = MaskYOLO(mode="inference", config=config, device=args.device)
    load_weights(model, args.weights)
    out = []
    for image_id in dataset.image_ids:
        image = dataset.load_image(image_id)
        r = model.detect(image, save_path=args.save_path)[0]
        print(f"image {image_id}: {len(r['class_ids'])} detections, "
              f"classes={r['class_ids'].tolist()}, "
              f"scores={[round(float(s), 3) for s in r['confidence_scores']]}")
        out.append(r)
    return out


def main(argv=None):
    from ...data.shapes import ShapesConfig

    config = ShapesConfig()
    config.BATCH_SIZE = 1
    return run(config, parser().parse_args(argv))


if __name__ == "__main__":
    main()
