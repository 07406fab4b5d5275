"""Export: weights + config → one `torch.export` detect artifact — port of
the JAX package's `tools/export_model.py`, with the same flags.

Load a trained checkpoint, trace the whole image → boxes + masks pipeline
with the weights inside (`MaskYOLO.export_model`, export.py), and write one
file that a deployment process serves with `ExportedDetector.load(path)`:
no model code, no checkpoint. --platforms lists the device types the
artifact may be loaded onto (cuda, cpu; default: the one it was traced on).

Examples:
  python -m mask_yolo_tpu_torch.tools.export_model --weights ./quality_run/weights \\
      --config shapes --out shapes_detect.pt2
  python -m mask_yolo_tpu_torch.tools.export_model --weights W \\
      --config-json ./ckpt/config.json --out coco_detect.pt2 --batch-size 32 \\
      --platforms cuda cpu
  python -m mask_yolo_tpu_torch.tools.export_model --out m.pt2 --config shapes \\
      --weights W --verify   # reload the artifact and check it against the live model
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ._common import add_device_flag, load_weights
from .predict import build_config  # shared --config/--config-json/--labels


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True,
                    help="checkpoint of MaskYOLO.save_weights / train, or a Keras .h5")
    ap.add_argument("--out", required=True, help="artifact file to write")
    ap.add_argument("--config", choices=["shapes", "coco"], default=None)
    ap.add_argument("--config-json", default=None,
                    help="config.json persisted by train()")
    ap.add_argument("--labels", default=None,
                    help="comma-separated label override")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="pin the batch (default: symbolic, any B)")
    ap.add_argument("--input-dtype", choices=["uint8", "float32"],
                    default="uint8")
    ap.add_argument("--platforms", nargs="+", default=None,
                    help="device types the artifact may load onto, e.g. "
                         "--platforms cuda cpu")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and compare against the live "
                         "model on a random batch")
    add_device_flag(ap)
    return ap


def verify(path, model, config, batch_size=None):
    """Reload the artifact onto the model's device and hold it against the
    live model on a random uint8 batch: classes, valid and scores exact,
    boxes within 1e-3 px, masks different on under 1e-3 of the pixels.
    Raises SystemExit on a mismatch (hard errors, not asserts: verification
    must not pass silently under `python -O`). Returns the share of mask
    pixels that differ."""
    from ..export import ExportedDetector

    det = ExportedDetector.load(path, device=model.device)
    b = batch_size or 2
    rng = np.random.RandomState(0)
    imgs = (rng.rand(b, *config.IMAGE_SHAPE) * 255).astype(np.uint8)
    got = {k: v.cpu().numpy() for k, v in det.detect_batch(imgs).items()}
    ref = {k: v.cpu().numpy() for k, v in model.detect_batch(imgs).items()}
    for k in ("classes", "valid", "scores"):
        if not np.array_equal(got[k], ref[k]):
            raise SystemExit(f"verify FAILED: {k} differs between "
                             f"artifact and live model")
    if not np.allclose(got["boxes"], ref["boxes"], atol=1e-3):
        raise SystemExit("verify FAILED: boxes differ beyond 1e-3 px")
    frac = float(np.mean(got["masks"] != ref["masks"]))
    # untrained/low-confidence models sit near the 0.5 mask threshold on
    # many boundary pixels, so allow up to 0.1% borderline flips
    if not frac < 1e-3:
        raise SystemExit(
            f"verify FAILED: masks differ on {frac:.2e} of pixels")
    print(f"verify: artifact matches live model on B={b} "
          f"(boxes atol 1e-3 px, {frac:.1e} borderline mask pixels)")
    return frac


def run(config, args):
    """Export the model of args.weights under `config` to args.out (and
    verify it with --verify). Returns the artifact's header."""
    from ..model import MaskYOLO

    model = MaskYOLO(mode="inference", config=config, device=args.device)
    load_weights(model, args.weights)
    header = model.export_model(args.out, batch_size=args.batch_size,
                                input_dtype=args.input_dtype,
                                platforms=args.platforms)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size_mb:.1f} MB) "
          f"platforms={header['platforms']} batch={header['batch_size']}")
    if args.verify:
        verify(args.out, model, config, args.batch_size)
    return header


def main(argv=None):
    args = parser().parse_args(argv)
    return run(build_config(args), args)


if __name__ == "__main__":
    main()
