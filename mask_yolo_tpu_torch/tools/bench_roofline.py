"""Measured peaks of the card: matmul rates in bf16, f32 and int8, and the
HBM copy rate — port of the JAX package's `tools/bench_roofline.py`, with
its flags and JSON lines.

These are yardsticks for the roofline columns of PERF.md, not kernels of
the port: `torch.matmul` of two seeded [size, size] matrices in bf16 and
f32 (the row records whether TF32 was on, which sets f32's tensor-core
rate), `torch._int_mm` in int8 (int32 out, the second operand column-major
as cuBLASLt wants it), and `torch.mul(x, c, out=y)` over --bandwidth-mb of
f32 (reading and writing each byte once: 2x its bytes a call). Each is
timed by `_timing.wall_ms` over back-to-back calls (a call at these sizes
takes longer on the card than Python takes to launch it).

Run: python -m mask_yolo_tpu_torch.tools.bench_roofline [--size 4096]
     [--dtypes bfloat16,float32,int8] [--bandwidth-mb 256] [--device cpu]
Prints one JSON line per probe; exits 1 if any probe failed.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import _timing
from ._common import add_device_flag

ITERS = 20


def matmul_call(name: str, size: int, device):
    """A call of the probe's product on seeded [size, size] operands."""
    import torch

    rng = np.random.RandomState(0)
    if name == "int8":
        a = torch.as_tensor(rng.randint(-127, 128, (size, size)), dtype=torch.int8)
        b = torch.as_tensor(rng.randint(-127, 128, (size, size)), dtype=torch.int8)
        a, b = a.to(device), b.to(device)
        # column-major second operand on the card (cuBLASLt's int8 layout)
        b = b.t().contiguous().t() if device.type == "cuda" else b
        return lambda: torch._int_mm(a, b)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    a = torch.as_tensor(rng.randn(size, size), dtype=dtype, device=device)
    b = torch.as_tensor(rng.randn(size, size), dtype=dtype, device=device)
    return lambda: torch.matmul(a, b)


def bench_dtype(name: str, size: int, device) -> dict:
    """{"tops": operations (2·size³) over the median call time in T/s}."""
    import torch

    ms = _timing.wall_ms(matmul_call(name, size, device), device, iters=ITERS)
    row = {"tops": 2.0 * size ** 3 / (ms * 1e-3) / 1e12, "ms": ms}
    if name == "float32":
        row["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    return row


def bench_bandwidth(mbytes: int, device) -> dict:
    """{"gbps": bytes read and written (2x the array) over the call time}."""
    import torch

    n = mbytes * (1 << 20) // 4
    x = torch.ones(n, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    ms = _timing.wall_ms(lambda: torch.mul(x, 1.0000001, out=y), device, iters=ITERS)
    return {"gbps": 2.0 * n * 4 / (ms * 1e-3) / 1e9, "ms": ms}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--dtypes", default="bfloat16,float32,int8")
    ap.add_argument("--bandwidth-mb", type=int, default=256,
                    help="HBM probe array size in MB (0 = skip)")
    add_device_flag(ap)
    return ap


def run(config, args):
    """The probes' rows (config: unused, for the tools' common signature)."""
    del config
    device = _timing.resolve_device(args.device)
    label = _timing.card(device)
    rows = []
    if args.bandwidth_mb:
        head = {"probe": "hbm_copy", "mb": args.bandwidth_mb}
        try:
            r = bench_bandwidth(args.bandwidth_mb, device)
            rows.append(_timing.emit({**head, "gbps": r["gbps"], "ms": r["ms"],
                                      "device": label}))
        except Exception as e:   # noqa: BLE001 - the JAX tool's error line
            rows.append(_timing.error_row(head, e))
    for name in args.dtypes.split(","):
        name = name.strip()
        try:
            r = bench_dtype(name, args.size, device)
            rows.append(_timing.emit({"dtype": name, "size": args.size,
                                      "tops": r["tops"], "ms": r["ms"],
                                      **({"tf32": r["tf32"]} if "tf32" in r else {}),
                                      "device": label}))
        except Exception as e:   # noqa: BLE001
            rows.append(_timing.error_row({"dtype": name}, e))
    return rows


def main(argv=None):
    return _timing.finish(run(None, parser().parse_args(argv)))


if __name__ == "__main__":
    main()
