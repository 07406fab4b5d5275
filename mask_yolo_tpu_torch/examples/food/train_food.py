"""Train / infer Mask-YOLO on the VIA-annotated Food dataset — port of the
JAX package's `examples/food/train_food.py`, with the same flags (see
examples/rice/train_rice.py, whose code it shares).

Run: python -m mask_yolo_tpu_torch.examples.food.train_food --dataset ./food
"""

from ..rice.train_rice import parser as _parser
from ..rice.train_rice import run_via


def parser():
    return _parser("food", __doc__)


def run(config, args):
    from ...data.via import ViaDataset

    def load(subset):
        ds = ViaDataset(source="food", class_name="food")
        ds.load_via(args.dataset, subset)
        ds.prepare()
        return ds

    return run_via(config, args, load)


def main(argv=None):
    from ...data.via import FoodConfig

    args = parser().parse_args(argv)
    config = FoodConfig()
    config.display()
    return run(config, args)


if __name__ == "__main__":
    main()
