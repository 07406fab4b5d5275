"""Generator sanity picture — port of the JAX package's
`examples/shapes/test_data_generator.py` (numpy and matplotlib on the
host: no device). Build Shapes data through load_image_gt +
BatchGenerator, pull one batch, render it with its GT boxes into
generator_sanity.png.

Run: python -m mask_yolo_tpu_torch.examples.shapes.test_data_generator
"""

import numpy as np


def run(config, args=None):
    """Pull one shuffled training batch of 4 and draw it; returns the
    batch."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ...data.pipeline import BatchGenerator, preload_dataset
    from ...data.shapes import ShapesDataset

    ds = ShapesDataset()
    ds.load_shapes(16, config.IMAGE_SHAPE[0], config.IMAGE_SHAPE[1], seed=0)
    ds.prepare()

    data = preload_dataset(ds, config)
    gen = BatchGenerator(data, config, mode="training", shuffle=True, seed=0)
    batch = gen[0]
    print("batch keys:", {k: v.shape for k, v in batch.items()})
    print("grid conf per image:",
          batch["yolo_target"][..., 4].sum(axis=(1, 2, 3)))

    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    for i, ax in enumerate(axes):
        ax.imshow(batch["image"][i])
        for box in batch["gt_boxes"][i]:
            if np.abs(box).sum() > 0:
                x1, y1, x2, y2 = box
                ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                           fill=False, edgecolor="red", lw=2))
        ax.axis("off")
    plt.savefig("generator_sanity.png", bbox_inches="tight")
    plt.close(fig)
    print("wrote generator_sanity.png")
    return batch


def main(argv=None):
    import argparse

    from ...data.shapes import ShapesConfig

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    config = ShapesConfig()
    config.BATCH_SIZE = 4
    return run(config, args)


if __name__ == "__main__":
    main()
