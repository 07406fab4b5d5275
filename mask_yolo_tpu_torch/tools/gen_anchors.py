"""Anchor k-means — port of the JAX package's `tools/gen_anchors.py`, with
the same flags and output (numpy on the host: no device).

Read GT boxes (from a boxes txt dump like the reference's rice_boxes.txt,
or directly from a dataset), run IoU k-means, write anchors_<k>.txt and,
with --sweep, an avg-IoU elbow plot (needs matplotlib).

Usage:
    python -m mask_yolo_tpu_torch.tools.gen_anchors --boxes boxes.txt --k 5 --grid 7 \\
        --out anchors_5.txt
    python -m mask_yolo_tpu_torch.tools.gen_anchors --dataset shapes --k 3 --sweep
"""

from __future__ import annotations

import argparse

import numpy as np


def load_boxes_txt(path, image_shape=(224, 224)):
    """Parse a boxes dump: one 'x1,y1,x2,y2' (or whitespace) box per line,
    pixel coordinates (the format of the reference's rice_boxes.txt)."""
    from ..utils.anchors import boxes_to_wh

    rows = []
    with open(path) as f:
        for line in f:
            parts = line.replace(",", " ").split()
            if len(parts) >= 4:
                rows.append([float(x) for x in parts[:4]])
    return boxes_to_wh(np.asarray(rows), image_shape)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--boxes", help="txt file of GT boxes (x1 y1 x2 y2 px)")
    ap.add_argument("--dataset", choices=["shapes"],
                    help="generate boxes from a built-in dataset")
    ap.add_argument("--via-dir", help="VIA dataset root (train/ subdir used)")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--grid", type=int, default=7)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep k=1..10 and save avg_iou.png")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def default_config(args):
    """The dataset's config: ShapesConfig for --dataset shapes, ViaConfig
    for --via-dir, none for --boxes."""
    if args.boxes:
        return None
    if args.dataset == "shapes":
        from ..data.shapes import ShapesConfig

        return ShapesConfig()
    from ..data.via import ViaConfig

    return ViaConfig()


def run(config, args):
    """k-means over the boxes of args (a dataset's under `config`); writes
    the anchors file and returns (anchors [k, 2], average IoU)."""
    from ..utils.anchors import anchors_from_dataset, gen_anchors, sweep_k

    wh = None
    if args.boxes:
        wh = load_boxes_txt(args.boxes, (args.image_size, args.image_size))
        anchors, avg = gen_anchors(wh, args.k, grid=args.grid, seed=args.seed)
    elif args.dataset == "shapes":
        from ..data.shapes import ShapesDataset

        ds = ShapesDataset()
        ds.load_shapes(200, config.IMAGE_SHAPE[0], config.IMAGE_SHAPE[1], seed=args.seed)
        ds.prepare()
        anchors, avg = anchors_from_dataset(ds, config, k=args.k, seed=args.seed)
    else:
        from ..data.via import ViaDataset

        ds = ViaDataset()
        ds.load_via(args.via_dir, "train")
        ds.prepare()
        anchors, avg = anchors_from_dataset(ds, config, k=args.k, seed=args.seed)

    flat = ", ".join(f"{v:.5f}" for v in anchors.reshape(-1))
    print(f"k={args.k} avgIoU={avg:.4f}")
    print(f"ANCHORS = [{flat}]")
    out = args.out or f"anchors_{args.k}.txt"
    with open(out, "w") as f:
        f.write(flat + "\n")
    print(f"wrote {out}")

    if args.sweep and wh is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ks, ious = sweep_k(wh, 10, seed=args.seed)
        plt.plot(ks, ious, marker="o")
        plt.xlabel("k (number of anchors)")
        plt.ylabel("avg IoU")
        plt.savefig("avg_iou.png", bbox_inches="tight")
        plt.close()
        print("wrote avg_iou.png")
    return anchors, avg


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if not (args.boxes or args.dataset or args.via_dir):
        ap.error("one of --boxes / --dataset / --via-dir required")
    return run(default_config(args), args)


if __name__ == "__main__":
    main()
