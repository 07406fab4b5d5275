"""Detection-only (YOLO branch) inference on Shapes images — port of the
JAX package's `examples/shapes/infer_shapes_yolo.py`, with the same flags:
run the yolo-mode model and draw the decoded, NMS'd boxes into --save-path
(needs matplotlib).

Run: python -m mask_yolo_tpu_torch.examples.shapes.infer_shapes_yolo --weights W
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
    """infer_yolo on --num-images seeded Shapes images; returns each
    image's boxes."""
    from ... import MaskYOLO
    from ...data.shapes import ShapesDataset

    dataset = ShapesDataset()
    dataset.load_shapes(args.num_images, config.IMAGE_SHAPE[0],
                        config.IMAGE_SHAPE[1], seed=args.seed)
    dataset.prepare()

    model = MaskYOLO(mode="yolo", config=config, device=args.device)
    load_weights(model, args.weights)
    out = []
    for image_id in dataset.image_ids:
        image = dataset.load_image(image_id)
        boxes = model.infer_yolo(image, save_path=args.save_path)
        print(f"image {image_id}: {len(boxes)} boxes")
        for b in boxes:
            print(f"  {config.LABELS[b['label']]} {b['score']:.3f} "
                  f"({b['xmin']:.2f},{b['ymin']:.2f})-({b['xmax']:.2f},{b['ymax']:.2f})")
        out.append(boxes)
    return out


def main(argv=None):
    from ...data.shapes import ShapesConfig

    config = ShapesConfig()
    config.BATCH_SIZE = 1
    return run(config, parser().parse_args(argv))


if __name__ == "__main__":
    main()
