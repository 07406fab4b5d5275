"""Visual sanity check of the Rice data pipeline — port of the JAX
package's `examples/rice/test_rice_generator.py`, with the same flags
(numpy and matplotlib on the host: no device): load the VIA annotations,
pull one batch through the generator, draw its GT boxes and masks.

Run: python -m mask_yolo_tpu_torch.examples.rice.test_rice_generator --dataset ./rice
"""

import argparse

import numpy as np


def parser(name="rice", doc=__doc__):
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--dataset", required=True, help=f"{name} dataset root")
    ap.add_argument("--subset", default="train")
    ap.add_argument("--save-path", default=f"./{name}_generator_check.png")
    return ap


def draw_first_batch(ds, config, save_path):
    """The first unshuffled training batch of `ds`, its first image drawn
    with its GT instances into save_path. Returns the batch."""
    from ...data.pipeline import BatchGenerator, preload_dataset
    from ...utils import visualize

    data = preload_dataset(ds, config)
    gen = BatchGenerator(data, config, mode="training", shuffle=False)
    batch = gen[0]

    image = (batch["image"][0] * 255).astype(np.uint8)
    ids = batch["gt_class_ids"][0]
    keep = ids > 0
    visualize.display_instances(
        image, batch["gt_boxes"][0][keep], batch["gt_masks"][0][:, :, keep],
        ids[keep], config.LABELS, save_path=save_path)
    print(f"wrote {save_path}: {int(keep.sum())} GT instances")
    return batch


def run(config, args):
    from ...data.via import RiceDataset

    ds = RiceDataset()
    ds.load_rice(args.dataset, args.subset)
    ds.prepare()
    return draw_first_batch(ds, config, args.save_path)


def main(argv=None):
    from ...data.via import RiceConfig

    return run(RiceConfig(), parser().parse_args(argv))


if __name__ == "__main__":
    main()
