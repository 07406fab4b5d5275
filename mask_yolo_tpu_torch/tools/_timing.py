"""What the measurement tools share: the timer, the device's busy share, the
card's label, the JSON rows and the exit code.

The JAX package's tools time with a `lax.scan` delta harness, built to
cancel a remote runner's fixed cost. The port times the call a user makes:

  wall_ms     the median over `reps` of the wall time of `iters`
              back-to-back calls, each rep closed by torch.cuda.synchronize()
              (host included: what a user pays), after `warmup` calls;
  device_ms   the summed time of the CUDA kernels of one call, from
              torch.profiler; device_ms / wall_ms is the row's
              `device_busy_share`, which tells a host-bound stage from a
              device-bound one. Off the card there is no device time: the
              share is None (a CPU run never reports a device metric).

A tool prints one JSON line a row. A row whose work raised carries
`"error"` in place of its timings; the tool goes on with its other rows and
exits 1 at the end (`finish`).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

WARMUP, REPS, ITERS = 3, 5, 10


def resolve_device(name: str):
    """torch.device(name); the card unless the caller asked for the CPU,
    and no fallback when there is none."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return device


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, device, warmup: int = WARMUP, reps: int = REPS, iters: int = ITERS) -> float:
    """Median over `reps` of the mean wall time of one call among `iters`
    back-to-back calls of fn(), each rep closed by a synchronize, in ms."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times) * 1e3


def device_ms(fn, device):
    """The summed device time of the CUDA kernels of one call of fn() (warm),
    in ms, from torch.profiler; None off the card."""
    if device.type != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3


def busy_share(fn, device, total_ms: float):
    """device_ms(fn) / total_ms, or None off the card."""
    dev = device_ms(fn, device)
    return None if dev is None else dev / total_ms


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name off the card."""
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={device.index or 0}"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip().splitlines()[0]
    import torch

    return torch.cuda.get_device_name(device)


def emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def error_row(head: dict, exc: BaseException) -> dict:
    return emit({**head, "error": f"{type(exc).__name__}: {exc}"})


def finish(rows):
    """A tool's main(): its rows, or exit 1 when any is an error line."""
    if any("error" in r for r in rows):
        raise SystemExit(1)
    return rows


def seeded_images(batch: int, shape, device, seed: int = 0):
    """[batch, *shape] float32 noise in [0, 1) from numpy's RandomState(seed),
    on `device`: the JAX tools' input batch."""
    import numpy as np
    import torch

    return torch.as_tensor(np.random.RandomState(seed).rand(batch, *shape)
                           .astype(np.float32), device=device)


def add_weights_flag(ap):
    ap.add_argument("--weights", default=None,
                    help="time these weights (a checkpoint of MaskYOLO.save_weights or "
                         "train, or a Keras .h5) instead of seeded ones; the JAX tool "
                         "times its seeded initialisation, as this one does without it")


def seeded_model(config, args):
    """MaskYOLO("inference", config, seed=0) on args.device, with --weights
    loaded when given."""
    from ..model import MaskYOLO
    from ._common import load_weights

    model = MaskYOLO("inference", config, seed=0, device=args.device)
    if getattr(args, "weights", None):
        load_weights(model, args.weights)
    return model


def quantized(model, config, device, calib_seed: int = 1, n: int = 4):
    """The int8 detector of `model`'s weights for `config`, calibrated on n
    noise images of RandomState(calib_seed), as the JAX tools calibrate."""
    from .. import weights
    from ..quant import QuantizedDetector

    calib = seeded_images(n, config.IMAGE_SHAPE, device, seed=calib_seed)
    return QuantizedDetector.from_variables(weights.to_jax_variables(model._host_state),
                                            config, calib, device=device, net=model.net)


def stage_rows(stages, images, device, extra=None, note=None):
    """Time each (name, fn) of `stages` on `images` with wall_ms, in order:
    one row a stage with the JAX tools' keys (`us_per_img`, `delta_us`: the
    difference to the previous row, `img_per_s`), the wall ms and the
    device's busy share; `extra` is added to each row. note(name, out), if
    given, returns a line for stderr about the stage's output, computed once
    before the timing (e.g. how many candidates reach the NMS)."""
    import sys

    import torch

    label = card(device)
    batch = images.shape[0]
    rows, prev = [], 0.0
    for name, fn in stages:
        head = {"stage": name, "batch": batch}
        try:
            with torch.inference_mode():
                out = fn(images)
                if note is not None and (line := note(name, out)):
                    print(f"# {name}: {line}", file=sys.stderr, flush=True)
                ms = wall_ms(lambda: fn(images), device)
                share = busy_share(lambda: fn(images), device, ms)
        except Exception as e:   # noqa: BLE001 - the JAX tools' error line
            rows.append(error_row(head, e))
            continue
        us = ms * 1e3 / batch
        rows.append(emit({**head, "us_per_img": us, "delta_us": us - prev,
                          "img_per_s": batch * 1e3 / ms, "ms": ms,
                          "device_busy_share": share, **(extra or {}), "device": label}))
        prev = us
    return rows
