"""Serve the dynamic-batching inference server over a trained checkpoint or
an export artifact — port of the JAX package's `tools/serve_model.py`, with
the same flags.

  python -m mask_yolo_tpu_torch.tools.serve_model --weights ./weights [--quantize] [--port 8000]
  python -m mask_yolo_tpu_torch.tools.serve_model --artifact m.pt2   # a torch.export
                                                  # artifact: no model code or checkpoint

POST /detect with an .npy-serialized uint8 [H, W, 3] image; JSON response.
See serve.py for the batching design and export.py for the artifact format.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ._common import add_device_flag, load_weights


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=None,
                    help="checkpoint of MaskYOLO.save_weights / train, or a Keras .h5 "
                         "(or use --artifact)")
    ap.add_argument("--artifact", default=None,
                    help="serve a torch.export artifact (tools/export_model.py) "
                         "instead of a checkpoint")
    ap.add_argument("--config", default="shapes",
                    choices=["shapes", "coco416"],
                    help="operating point (Config subclass)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="static serving batch (default 8, or the "
                         "artifact's pinned batch)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--quantize", action="store_true",
                    help="serve the int8 PTQ path (calibrates on noise)")
    ap.add_argument("--score-threshold", type=float, default=0.35)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    add_device_flag(ap)
    return ap


def base_config(name):
    from ..config import CocoStyleConfig
    from ..data.shapes import ShapesConfig

    return {"shapes": ShapesConfig, "coco416": CocoStyleConfig}[name]()


def start(config, args):
    """Load the model (from args.weights under `config`, with BATCH_SIZE
    set to the serving batch, or from args.artifact, whose header is the
    config), warm it up and start the HTTP server. Returns (server,
    executor); stop them with server.stop() and executor.shutdown()."""
    from ..serve import BatchingExecutor, InferenceServer

    if args.artifact:
        from ..export import ExportedDetector

        model = ExportedDetector.load(args.artifact, device=args.device)
        cfg = model.serve_config(batch_size=args.batch_size)
    else:
        from ..model import MaskYOLO

        cfg = type("ServeConfig", (type(config),), {"BATCH_SIZE": args.batch_size or 8})()
        model = MaskYOLO(mode="inference", config=cfg, device=args.device)
        load_weights(model, args.weights)
        if args.quantize:
            calib = np.random.RandomState(0).rand(
                4, *cfg.IMAGE_SHAPE).astype(np.float32)
            model.quantize(calib)
    ex = BatchingExecutor(model, cfg, batch_size=cfg.BATCH_SIZE,
                          max_delay_s=args.max_delay_ms / 1e3,
                          score_threshold=args.score_threshold)
    try:
        # the kernel build and the first launches happen on the worker
        # thread, off the request path
        ex.warmup()
        server = InferenceServer(ex, host=args.host, port=args.port).start()
    except BaseException:
        ex.shutdown()
        raise
    print(f"serving on http://{server.host}:{server.port}  "
          f"(batch {cfg.BATCH_SIZE}, {'int8' if args.quantize else 'float'})",
          flush=True)
    return server, ex


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if bool(args.weights) == bool(args.artifact):
        ap.error("exactly one of --weights / --artifact is required")
    if args.artifact:
        if args.quantize:
            ap.error("--quantize applies at export time, not to an artifact")
        if "--config" in (sys.argv[1:] if argv is None else argv):
            ap.error("--config is determined by the artifact header; it "
                     "cannot be overridden when serving --artifact")
    server, ex = start(None if args.artifact else base_config(args.config), args)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        ex.shutdown()


if __name__ == "__main__":
    main()
