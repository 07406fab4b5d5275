"""Materialize the textured 81-class COCO-format datasets on the host — port
of the JAX package's `tools/materialize_textured.py`, with the same flags
(numpy and PIL: no device).

Writes the three splits (same seeds, counts and paths) that
`python -m mask_yolo_tpu_torch.tools.quality_run_coco --textured
--train-images 6000 --val-images 64 --eval-images 64 --out <dir>` expects,
so that run reuses them instead of generating them first. Safe to kill and
re-run: each split is only reused once its instances.json holds the full
image count and its sidecar the same parameters.

Run: python -m mask_yolo_tpu_torch.tools.materialize_textured [--out ./quality_run_coco_r4t]
"""

from __future__ import annotations

import argparse
import os
import time

from .quality_run_coco import _make_coco_copy


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="./quality_run_coco_r4t")
    ap.add_argument("--train-images", type=int, default=6000)
    ap.add_argument("--val-images", type=int, default=64)
    ap.add_argument("--eval-images", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-classes", type=int, default=80)
    return ap


def run(config, args):
    """Write the val, eval and train splits at config.IMAGE_SHAPE (default:
    CocoStyleConfig's 416²). Returns the three CocoDatasets by name."""
    size = 416 if config is None else config.IMAGE_SHAPE[0]
    splits = {}
    for name, count, seed in (("coco_val", args.val_images, args.seed + 1),
                              ("coco_eval", args.eval_images, args.seed + 2),
                              ("coco_train", args.train_images, args.seed)):
        t0 = time.time()
        splits[name] = _make_coco_copy(os.path.join(args.out, name), count, seed,
                                       args.num_classes, textured=True, size=size)
        print(f"{name}: {len(splits[name].image_ids)} images ready "
              f"({time.time() - t0:.0f}s)", flush=True)
    return splits


def main(argv=None):
    return run(None, parser().parse_args(argv))


if __name__ == "__main__":
    main()
