"""Training throughput at the Shapes 224² point — port of the JAX package's
`tools/bench_train.py`, with its flags and JSON keys.

Two measurements:

(a) the train step alone: `trainer.make_train_step` called back to back on
    one batch already on the device (the first Shapes batch of seed 0);
    `device_only_images_per_sec` is the batch over the median wall time of
    a step (`_timing.wall_ms`), and `device_busy_share` the step's CUDA
    kernel time over that wall time (the step is host-bound where it is
    well under 1). --split also times the loss forward alone (no gradient,
    no update), as the JAX tool's training-roofline split does.
(b) the end-to-end epoch: `trainer.run_epoch` through `BatchGenerator` (or,
    with --augment, the endless `data_generator` with `default_augmenter`)
    and `DevicePrefetcher`, the best of 3 epochs after a warm one, by wall
    clock (run_epoch reads the last step's metrics, which waits for the
    device). `mb_per_step` is the bytes of the first batch as the generator
    gives it; `payload` names its form.

The config's COMPUTE_DTYPE is bf16 unless --compute-dtype says otherwise;
the JSON records the TF32 state (`tf32`: matmul and cuDNN), which --tf32
on|off sets and which torch's defaults leave matmul off and cuDNN on.
Weights: MaskYOLO("training", seed=0) (flax's default initializers),
fresh for each measurement.

Usage: python -m mask_yolo_tpu_torch.tools.bench_train [--batch 16] [--images 256]
  [--legacy] [--augment] [--split] [--config shapes|coco416]
  [--compute-dtype float32] [--tf32 on|off] [--skip-device] [--skip-e2e] [--device cpu]
  --legacy re-measures with round-1-style batches (float32 images +
  full-canvas masks: USE_MINI_MASK = False).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import _timing
from ._common import add_device_flag

LR = 1e-3
STEP_TIMING = dict(warmup=2, reps=3, iters=5)
E2E_EPOCHS = 3


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--legacy", action="store_true",
                    help="round-1-style batches (float32 + full masks)")
    ap.add_argument("--augment", action="store_true",
                    help="time the augmented data_generator path")
    ap.add_argument("--skip-device", action="store_true")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="also time the loss forward alone (fwd/bwd split for the "
                         "training roofline)")
    ap.add_argument("--config", default="shapes", choices=["shapes", "coco416"],
                    help="coco416 = CocoStyleConfig (81 classes, 416²) on Shapes scenes")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--tf32", default=None, choices=["on", "off"],
                    help="set TF32 for matmul and cuDNN (default: torch's defaults)")
    add_device_flag(ap)
    return ap


def run_config(args, base=None):
    """The --config's class (or `base`) at --batch and --compute-dtype."""
    if base is None:
        from ..config import CocoStyleConfig
        from ..data.shapes import ShapesConfig

        base = {"shapes": ShapesConfig, "coco416": CocoStyleConfig}[args.config]
    return type("BenchConfig", (base,), {"BATCH_SIZE": args.batch,
                                         "COMPUTE_DTYPE": args.compute_dtype})()


def shapes(count, cfg):
    from ..data.shapes import ShapesDataset

    ds = ShapesDataset()
    ds.load_shapes(count, *cfg.IMAGE_SHAPE[:2], seed=0)
    ds.prepare()
    return ds


def fresh(cfg, device):
    """(model, train state, optimizer) from the seeded initialisation."""
    from ..model import MaskYOLO
    from ..train import state as state_lib

    model = MaskYOLO("training", cfg, seed=0, device=device)
    tx = state_lib.make_optimizer(LR, cfg, dict(model.net.named_parameters()))
    return model, state_lib.create_train_state(model.net, tx), tx


def bench_device_steps(cfg, device, fwd_only=False):
    """(images/s, device busy share) of the train step (or the loss
    forward alone) on one resident batch."""
    import torch

    from ..data.pipeline import BatchGenerator, preload_dataset
    from ..data.prefetch import to_device
    from ..pipelines import training_loss
    from ..train import trainer

    gen = BatchGenerator(preload_dataset(shapes(cfg.BATCH_SIZE, cfg), cfg), cfg,
                         mode="training", shuffle=False)
    batch = to_device(gen[0], device)
    _, st, tx = fresh(cfg, device)
    if fwd_only:
        def call():
            with torch.no_grad():
                return training_loss(st.net, batch, cfg, seen=float(st.step), train=True)[0]
    else:
        step = trainer.make_train_step(cfg, tx)

        def call():
            return step(st, batch)[1]["loss"]
    ms = _timing.wall_ms(call, device, **STEP_TIMING)
    return cfg.BATCH_SIZE * 1e3 / ms, _timing.busy_share(call, device, ms), ms


def epoch_source(cfg, n_images, legacy, augment):
    """(generator of the epoch's batches, bytes of its first batch)."""
    from ..data.pipeline import (BatchGenerator, GeneratorEpochSource, data_generator,
                                 preload_dataset)

    ds = shapes(n_images, cfg)
    if augment:
        from ..data.augment import default_augmenter

        endless = data_generator(ds, cfg, shuffle=True, augmentation=default_augmenter(seed=0),
                                 seed=0)
        gen = GeneratorEpochSource(endless, n_images // cfg.BATCH_SIZE, cfg)
    else:
        data = preload_dataset(ds, cfg)
        if legacy:   # round-1-style float32 image payload
            data = dict(data, images=data["images"].astype(np.float32) / 255.0)
        gen = BatchGenerator(data, cfg, mode="training", shuffle=False)
    return gen, sum(np.asarray(v).nbytes for v in gen[0].values())


def bench_epoch(cfg, device, n_images, legacy, augment):
    from ..train import trainer

    if legacy:
        cfg = type("LegacyCfg", (type(cfg),), {"USE_MINI_MASK": False})()
    gen, nbytes = epoch_source(cfg, n_images, legacy, augment)
    _, st, tx = fresh(cfg, device)
    step = trainer.make_train_step(cfg, tx)
    st, _ = trainer.run_epoch(step, st, gen, verbose=False)   # warm
    best = float("inf")
    for _ in range(E2E_EPOCHS):
        t0 = time.perf_counter()
        st, _ = trainer.run_epoch(step, st, gen, verbose=False)
        best = min(best, time.perf_counter() - t0)
    n_steps = len(gen)
    return {"images_per_sec": n_steps * cfg.BATCH_SIZE / best, "sec_per_step": best / n_steps,
            "mb_per_step": nbytes / 1e6}


def tf32_state(args):
    import torch

    if args.tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
            args.tf32 == "on")
    return {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}


def run(config, args):
    """The tool's one JSON row for `config`."""
    device = _timing.resolve_device(args.device)
    out = {"batch_size": config.BATCH_SIZE, "config": args.config,
           "compute_dtype": config.COMPUTE_DTYPE, "tf32": tf32_state(args),
           "device": _timing.card(device)}
    if not args.skip_device:
        ips, share, ms = bench_device_steps(config, device)
        out.update(device_only_images_per_sec=ips, step_ms=ms, device_busy_share=share)
        print(f"# train step: {ips:,.0f} img/s", file=sys.stderr, flush=True)
        if args.split:
            fwd, fwd_share, _ = bench_device_steps(config, device, fwd_only=True)
            out.update(fwd_only_images_per_sec=fwd, fwd_us_per_img=1e6 / fwd,
                       step_us_per_img=1e6 / ips, bwd_opt_over_fwd=fwd / ips - 1,
                       fwd_device_busy_share=fwd_share)
            print(f"# fwd-only: {fwd:,.0f} img/s", file=sys.stderr, flush=True)
    if not args.skip_e2e:
        e = bench_epoch(config, device, args.images, args.legacy, args.augment)
        out.update({
            "e2e_images_per_sec": e["images_per_sec"],
            "e2e_sec_per_step": e["sec_per_step"],
            "mb_per_step": e["mb_per_step"],
            "payload": "legacy_f32_fullmask" if args.legacy else "uint8_minimask",
            "augmented_generator": bool(args.augment),
        })
    return [_timing.emit(out)]


def main(argv=None):
    args = parser().parse_args(argv)
    return _timing.finish(run(run_config(args), args))


if __name__ == "__main__":
    main()
