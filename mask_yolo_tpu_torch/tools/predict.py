"""Batch prediction: run the detect pipeline over image files and write
COCO "results"-format JSON (and overlay PNGs) — port of the JAX package's
`tools/predict.py`, with the same flags and output.

Batched, optionally int8-quantized and/or split over the ranks of a
`torch.distributed` job, with machine-readable output any COCO scorer
accepts (data/coco.detections_to_coco_results). Images whose size differs
from Config.IMAGE_SHAPE are resized on the host (utils.image.resize_image —
the reference's per-axis stretch) and the boxes and masks of the output are
mapped back to the original frames.

--weights takes a checkpoint of `MaskYOLO.save_weights` or `train` (the
port's format) or a Keras-2 `.h5` file; --config-json the config.json that
`train` writes beside its checkpoints (the JAX package's or the port's).
--mesh detects each batch over the job's ranks (`parallel/`: every rank
runs this command with the MYOLO_* variables or torchrun's set; each
detects its share of every batch, and the chief writes the one JSON); a
single process is a world of one.

Examples:
  python -m mask_yolo_tpu_torch.tools.predict --weights ./quality_run/weights \\
      --config shapes --images ./my_pngs --out results.json --overlays 4
  python -m mask_yolo_tpu_torch.tools.predict --weights W --config-json ./ckpt/config.json \\
      --images a.png b.png --quantize --labels background,square,...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ._common import add_device_flag, load_weights

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def build_config(args):
    """The config of --config (shapes, coco, or the base Config), with the
    UPPERCASE knobs of --config-json and then --labels on top."""
    from ..config import CocoStyleConfig, Config
    from ..data.shapes import ShapesConfig

    base = {"shapes": ShapesConfig, "coco": CocoStyleConfig,
            None: Config}[args.config]
    fields = {}
    if args.config_json:
        with open(args.config_json) as f:
            loaded = json.load(f)
        # config.json (written by train()) serializes every attribute;
        # real knobs are UPPERCASE, derived helpers are lowercase properties
        fields.update({k: v for k, v in loaded.items() if k.isupper()})
    if args.labels:  # applies on top of --config-json too
        labels = args.labels.split(",")
        fields["LABELS"] = labels
        fields["NUM_CLASSES"] = len(labels)
    if fields:
        return type("RunConfig", (base,), fields)()
    return base()


def iter_image_paths(specs):
    for spec in specs:
        if os.path.isdir(spec):
            for name in sorted(os.listdir(spec)):
                if name.lower().endswith(IMAGE_EXTS):
                    yield os.path.join(spec, name)
        else:
            yield spec


def assign_image_ids(paths):
    """COCO image_id per path: the numeric filename stem when stems are
    globally unambiguous (so results line up with annotation files that use
    numeric ids), else the path itself — '7.png' vs '007.png' or the same
    stem in two input directories must not merge into one id."""
    ids = []
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        ids.append(int(stem) if stem.isdigit() else stem)
    return ids if len(set(ids)) == len(ids) else list(paths)


def load_image(path, net_hw):
    """(original uint8 [h, w, 3], network-size float [H, W, 3] in [0, 1],
    the per-axis scale of resize_image)."""
    from PIL import Image

    from ..utils.image import resize_image

    img = np.asarray(Image.open(path).convert("RGB"))
    resized, scale = resize_image(img, net_hw)
    return img, resized.astype(np.float32) / 255.0, scale


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True,
                    help="checkpoint of MaskYOLO.save_weights / train, or a Keras .h5")
    ap.add_argument("--images", nargs="+", required=True,
                    help="image files and/or directories")
    ap.add_argument("--config", choices=["shapes", "coco"], default=None)
    ap.add_argument("--config-json", default=None,
                    help="config.json written by train() next to checkpoints "
                         "(reconstructs the exact training config)")
    ap.add_argument("--labels", default=None,
                    help="comma-separated class names (background first)")
    ap.add_argument("--out", default="predictions.json")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 path (PTQ calibrated on the first batch)")
    ap.add_argument("--qat-steps", type=int, default=0,
                    help="label-free QAT finetune steps after PTQ")
    ap.add_argument("--mesh", action="store_true",
                    help="split each batch over the ranks of the torch.distributed job")
    ap.add_argument("--overlays", type=int, default=0,
                    help="save overlay PNGs for the first N images")
    ap.add_argument("--overlay-dir", default="./img_results")
    ap.add_argument("--coco-categories", default=None,
                    help="COCO annotation JSON whose categories define the "
                         "category_id mapping — REQUIRED for scoring against "
                         "real COCO annotations (non-contiguous ids); "
                         "omit for datasets written by dataset_to_coco_json")
    add_device_flag(ap)
    return ap


def run(config, args):
    """Detect every image of args.images with `config` and the weights of
    args.weights; the chief writes the results to args.out. Returns the
    COCO results list."""
    import torch

    from ..data.coco import coco_category_map, detections_to_coco_results
    from ..model import MaskYOLO
    from ..parallel import mesh as mesh_lib

    net_h, net_w = config.IMAGE_SHAPE[:2]
    category_map = (coco_category_map(args.coco_categories)
                    if args.coco_categories else None)

    paths = list(iter_image_paths(args.images))
    if not paths:
        raise SystemExit("no images found")
    image_ids = assign_image_ids(paths)

    model = MaskYOLO(mode="inference", config=config, device=args.device)
    load_weights(model, args.weights)
    chief = not (torch.distributed.is_initialized() and torch.distributed.get_rank() != 0)

    results = []
    n_batches = (len(paths) + args.batch_size - 1) // args.batch_size
    for b in range(n_batches):
        chunk = paths[b * args.batch_size:(b + 1) * args.batch_size]
        loaded = [load_image(p, (net_h, net_w)) for p in chunk]
        if b == 0 and args.quantize:  # calibrate on the already-loaded batch
            model.quantize(np.stack([l[1] for l in loaded]),
                           finetune_steps=args.qat_steps)
        batch = np.stack([l[1] for l in loaded])
        if len(chunk) < args.batch_size:  # pad: every batch has one shape
            batch = np.concatenate([batch, np.zeros(
                (args.batch_size - len(chunk), net_h, net_w, 3), np.float32)])
        if args.mesh:   # this rank's share, then every rank's gathered
            share = batch[mesh_lib.batch_slice(args.batch_size, model.mesh)]
            out = mesh_lib.gather_batch(model.detect_batch(share, mesh=True), model.mesh)
        else:
            out = model.detect_batch(batch)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for bi, (orig, _, scale) in enumerate(loaded):
            keep = out["valid"][bi] & (out["scores"][bi] >= args.score_threshold)
            idx = np.where(keep)[0]
            results.extend(detections_to_coco_results(
                image_ids[b * args.batch_size + bi],
                out["boxes"][bi][idx],
                out["classes"][bi][idx],
                out["scores"][bi][idx],
                np.transpose(out["masks"][bi][idx], (1, 2, 0)),
                scale=scale, category_map=category_map))
            n_done = b * args.batch_size + bi
            if chief and n_done < args.overlays:
                from ..utils import visualize

                os.makedirs(args.overlay_dir, exist_ok=True)
                labels = (config.LABELS or
                          [str(i) for i in range(config.NUM_CLASSES)])
                resized_u8 = (batch[bi] * 255).astype(np.uint8)
                visualize.display_instances(
                    resized_u8, out["boxes"][bi][idx],
                    np.transpose(out["masks"][bi][idx], (1, 2, 0)),
                    out["classes"][bi][idx], labels, out["scores"][bi][idx],
                    save_path=os.path.join(
                        args.overlay_dir,
                        "predict-" + os.path.splitext(
                            os.path.basename(chunk[bi]))[0] + ".png"))
        if chief:
            print(f"batch {b + 1}/{n_batches} done", flush=True)

    if chief:
        with open(args.out, "w") as f:
            json.dump(results, f)
        print(f"{len(results)} detections over {len(paths)} images -> {args.out}")
    return results


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if not (args.config or args.config_json):
        ap.error("one of --config / --config-json is required")
    if not args.mesh:
        return run(build_config(args), args)
    from ..parallel import distributed

    distributed.initialize(device=args.device)
    try:
        return run(build_config(args), args)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
