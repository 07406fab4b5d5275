"""The `torch.export` artifact against the live detect pipeline — port of
the JAX package's `tools/bench_export.py`, with its flags and JSON lines.

For each flavor (bf16: the float network in the config's dtype; int8:
after MaskYOLO.quantize on 4 noise images of RandomState(1), the config's
own int8 knobs) the model is exported (`export_model`, float32 input,
symbolic batch), loaded back through `export.ExportedDetector`, and both
are timed on the same [batch, H, W, 3] noise batch of RandomState(0):
`live_img_per_s` (MaskYOLO.detect_batch), `artifact_img_per_s`
(ExportedDetector.detect_batch), `artifact_vs_live`, the artifact header's
`compute_path`, and `outputs_equal` (the two outputs bit for bit).

Weights: MaskYOLO("inference", seed=0). Timing: `_timing`
(wall time of back-to-back calls). A flavor that raises prints {"config",
"flavor", "error"} and the tool exits 1 after the others.

Run: python -m mask_yolo_tpu_torch.tools.bench_export [--config shapes|coco416]
     [--batch 128] [--flavors bf16,int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from . import _timing
from ._common import add_device_flag


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="coco416", choices=["shapes", "coco416"])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--flavors", default="bf16,int8")
    add_device_flag(ap)
    return ap


def run_config(args, base=None):
    """The --config's class (or `base`) with BATCH_SIZE = --batch."""
    if base is None:
        from ..config import CocoStyleConfig
        from ..data.shapes import ShapesConfig

        base = {"shapes": ShapesConfig, "coco416": CocoStyleConfig}[args.config]
    return type("Cfg", (base,), {"BATCH_SIZE": args.batch})()


def same_outputs(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def run(config, args):
    """One row a flavor of --flavors."""
    import torch

    from ..export import ExportedDetector

    model = _timing.seeded_model(config, args)
    device = model.device
    images = _timing.seeded_images(args.batch, config.IMAGE_SHAPE, device)
    label = _timing.card(device)
    rows = []
    for flavor in args.flavors.split(","):
        flavor = flavor.strip()
        head = {"config": args.config, "flavor": flavor}
        try:
            if flavor == "int8":
                model.quantize(_timing.seeded_images(4, config.IMAGE_SHAPE, device, seed=1))
            else:
                model._invalidate_infer_fns()   # back to the float network
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, f"detect_{flavor}.pt2")
                header = model.export_model(path, input_dtype="float32")
                art = ExportedDetector.load(path, device=device)
                with torch.inference_mode():
                    equal = same_outputs(art.detect_batch(images), model.detect_batch(images))
                    live = _timing.wall_ms(lambda: model.detect_batch(images), device)
                    artifact = _timing.wall_ms(lambda: art.detect_batch(images), device)
        except Exception as e:   # noqa: BLE001 - the JAX tool's error line
            rows.append(_timing.error_row(head, e))
            continue
        rows.append(_timing.emit({
            **head, "batch": args.batch, "live_img_per_s": args.batch * 1e3 / live,
            "artifact_img_per_s": args.batch * 1e3 / artifact,
            "artifact_vs_live": live / artifact, "compute_path": header["compute_path"],
            "outputs_equal": equal, "live_ms": live, "artifact_ms": artifact,
            "device": label}))
    return rows


def main(argv=None):
    args = parser().parse_args(argv)
    return _timing.finish(run(run_config(args), args))


if __name__ == "__main__":
    main()
