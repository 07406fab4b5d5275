"""Visual sanity check of the Food data pipeline — port of the JAX
package's `examples/food/test_food_generator.py`, with the same flags
(numpy and matplotlib on the host: no device; see
examples/rice/test_rice_generator.py).

Run: python -m mask_yolo_tpu_torch.examples.food.test_food_generator --dataset ./food
"""

from ..rice.test_rice_generator import draw_first_batch
from ..rice.test_rice_generator import parser as _parser


def parser():
    return _parser("food", __doc__)


def run(config, args):
    from ...data.via import FoodDataset

    ds = FoodDataset()
    ds.load_food(args.dataset, args.subset)
    ds.prepare()
    return draw_first_batch(ds, config, args.save_path)


def main(argv=None):
    from ...data.via import FoodConfig

    return run(FoodConfig(), parser().parse_args(argv))


if __name__ == "__main__":
    main()
