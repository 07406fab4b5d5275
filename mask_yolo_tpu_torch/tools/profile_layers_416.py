"""Per-layer timing of the int8 trunk at the 416², 81-class point
(CocoStyleConfig) — port of the JAX package's `tools/profile_layers_416.py`,
with its flags and JSON lines.

For every layer of the quantized trunk, neck and YOLO head
(`quant.build_layer_graph` order, run as the chained int8 path runs it,
each layer's dequantize → bias → activation → requantize epilogue
included), this tool:

  1. times the layer alone (`quant.run_layer_int8`) at the operating
     point's true input shape, dtype and scale: `walk` derives them as the
     JAX tool's walk does (`:238`), each part (trunk from the image; neck
     and yolo each from C4) entering in f32 and handing int8 on wherever
     the next layer has a scale;
  2. times `torch._int_mm` on the same contraction (M = B·Ho·Wo,
     K = kh·kw·Cin, N = Cout) for a dense int8 layer: the layer's GEMM with
     no conv lowering or epilogue. On the card `_int_mm` needs M > 16 and
     K, N multiples of 8, so K and N are zero-padded as `ops.int8.int_mm`
     pads them (the stem's K = 27 becomes 32; `gemm_shape` gives the
     padded [M, K, N]); the rate counts the unpadded operations;
  3. reports µs/img, GFLOP/img, the achieved TOP/s, the GB/s of the
     layer's input and output (the figure of merit of a depthwise layer,
     which moves bytes more than it multiplies) and the layer's time
     against the GEMM's.
A last row times the whole trunk + neck + YOLO head (`quant._trunk_outputs`)
beside the sum of the isolated layers. --prefix instead times the chains of
the first 1, 2, … layers of each part (`quant.run_layers`), whose
differences are each layer's cost in the chain.

No row runs a fused pair (K1): the rows are the chained layers, as in the
JAX tool. Weights: MaskYOLO("inference", seed=0), quantized on
4 noise images of RandomState(1). Timing: `_timing.wall_ms` (wall time of
back-to-back calls closed by a synchronize).

Run: python -m mask_yolo_tpu_torch.tools.profile_layers_416 [--batch 128]
     [--layers a,b] [--skip-gemm] [--skip-whole] [--prefix]
     [--device cpu]
Prints one JSON line per layer; exits 1 if a layer failed.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from . import _timing
from ._common import add_device_flag
from .profile_stages_416 import bench_config


def walk(layers, hw, cin):
    """Each layer's (layer, in_hw, cin, out_hw, cout, kh, kw, in_scale,
    out_scale) along one part entered in f32 (the JAX tool's walk), and
    the part's output (hw, channels)."""
    from .. import quant

    scale = None
    rows = []
    for i, layer in enumerate(layers):
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        out_scale = nxt.a_scale if nxt is not None and quant._scale_ok(nxt.a_scale) else None
        kh, kw, _, cout = np.asarray(layer.kernel).shape   # dw kernels [kh, kw, 1, C]
        ho, wo = math.ceil(hw[0] / layer.strides[0]), math.ceil(hw[1] / layer.strides[1])
        rows.append(dict(layer=layer, in_hw=tuple(hw), cin=cin, out_hw=(ho, wo), cout=cout,
                         kh=kh, kw=kw, in_scale=scale, out_scale=out_scale))
        hw, cin, scale = (ho, wo), cout, out_scale
    assert scale is None   # each part ends in an f32 output layer
    return rows, hw, cin


def walk_graph(graph, cfg):
    """The walk of the trunk (from the image) and of the neck and the YOLO
    head (each from C4)."""
    rows, c4_hw, c4_c = walk(graph["trunk"], tuple(cfg.IMAGE_SHAPE[:2]), 3)
    return (rows + walk(graph["neck"], c4_hw, c4_c)[0]
            + walk(graph["yolo"], c4_hw, c4_c)[0])


def contraction(r, batch):
    """(M, K, N, operations a batch) of a walk row's conv."""
    layer = r["layer"]
    m = batch * r["out_hw"][0] * r["out_hw"][1]
    if layer.groups == 1:
        k, n = r["kh"] * r["kw"] * r["cin"], r["cout"]
        return m, k, n, 2.0 * m * k * n
    return m, r["kh"] * r["kw"], 1, 2.0 * m * r["kh"] * r["kw"] * r["cout"]


def layer_input(r, batch, device, rng):
    import torch

    shape = (batch, *r["in_hw"], r["cin"])
    if r["in_scale"] is not None:
        return torch.as_tensor(rng.randint(-127, 128, shape), dtype=torch.int8, device=device)
    return torch.as_tensor(rng.rand(*shape).astype(np.float32), device=device)


def gemm_call(m, k, n, device):
    """(a call of torch._int_mm on [m, k] x [k, n] int8 operands padded as
    ops.int8.int_mm pads them, the padded [M, K, N])."""
    import torch

    from ..ops.int8 import _round8

    mp = max(m, 17) if device.type == "cuda" else m
    kp, np8 = _round8(k), _round8(n)
    rng = np.random.RandomState(0)
    a = torch.as_tensor(rng.randint(-127, 128, (mp, kp)), dtype=torch.int8, device=device)
    b = torch.as_tensor(rng.randint(-127, 128, (np8, kp)), dtype=torch.int8, device=device).t()
    if device.type != "cuda":
        b = b.contiguous()
    return (lambda: torch._int_mm(a, b)), [mp, kp, np8]


def layer_row(r, batch, device, rng, skip_gemm):
    from .. import quant

    layer = r["layer"]
    m, k, n, ops = contraction(r, batch)
    x0 = layer_input(r, batch, device, rng)
    int8 = bool(layer.quantize and layer.w_q is not None)
    out = {"layer": layer.name, "kind": layer.kind, "in": [*r["in_hw"], r["cin"]],
           "out": [*r["out_hw"], r["cout"]], "stride": layer.strides[0], "int8": int8,
           "gflop_per_img": ops / batch / 1e9}
    ms = _timing.wall_ms(lambda: quant.run_layer_int8(layer, x0, r["in_scale"],
                                                      r["out_scale"]), device)
    in_b = 1 if r["in_scale"] is not None else 4
    out_b = 1 if r["out_scale"] is not None else 4
    nbytes = batch * (r["in_hw"][0] * r["in_hw"][1] * r["cin"] * in_b
                      + r["out_hw"][0] * r["out_hw"][1] * r["cout"] * out_b)
    out.update(us_per_img=ms * 1e3 / batch, eff_tops=ops / (ms * 1e-3) / 1e12,
               gbps=nbytes / (ms * 1e-3) / 1e9, ms=ms)
    if not skip_gemm and layer.groups == 1 and int8:
        call, padded = gemm_call(m, k, n, device)
        g_ms = _timing.wall_ms(call, device)
        out.update(gemm_us_per_img=g_ms * 1e3 / batch, gemm_tops=ops / (g_ms * 1e-3) / 1e12,
                   pct_of_gemm=100.0 * g_ms / ms, gemm_shape=padded)
    return out, ms


def prefix_rows(graph, cfg, batch, device, rng, label):
    """Cumulative chains of each part (module docstring)."""
    import torch

    from .. import quant

    h, w = cfg.IMAGE_SHAPE[:2]
    c4 = torch.as_tensor(rng.rand(batch, math.ceil(h / 8), math.ceil(w / 8), 512)
                         .astype(np.float32) * 6.0, device=device)
    parts = (("trunk", _timing.seeded_images(batch, cfg.IMAGE_SHAPE, device)),
             ("neck", c4), ("yolo", c4))
    rows = []
    for part, x0 in parts:
        layers, prev = graph[part], 0.0
        for i in range(1, len(layers) + 1):
            head = {"prefix": f"{part}:{layers[i - 1].name}"}
            try:
                ms = _timing.wall_ms(lambda: quant.run_layers(layers[:i], x0, quant=True),
                                     device)
            except Exception as e:   # noqa: BLE001 - the JAX tools' error line
                rows.append(_timing.error_row(head, e))
                continue
            us = ms * 1e3 / batch
            rows.append(_timing.emit({**head, "cum_us_per_img": us,
                                      "marginal_us_per_img": us - prev, "device": label}))
            prev = us
    return rows


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--layers", default=None,
                    help="comma-separated layer-name filter (default: all)")
    ap.add_argument("--skip-gemm", action="store_true")
    ap.add_argument("--skip-whole", action="store_true")
    ap.add_argument("--prefix", action="store_true",
                    help="marginal in-chain costs from prefix differences instead of "
                         "isolated layers")
    add_device_flag(ap)
    return ap


def run(config, args):
    import torch

    from .. import quant

    model = _timing.seeded_model(config, args)
    device = model.device
    det = _timing.quantized(model, config, device)
    label = _timing.card(device)
    rng = np.random.RandomState(0)
    b = args.batch
    with torch.inference_mode():
        if args.prefix:
            return prefix_rows(det.graph, config, b, device, rng, label)
        only = set(args.layers.split(",")) if args.layers else None
        rows, sum_us = [], 0.0
        for r in walk_graph(det.graph, config):
            if only and r["layer"].name not in only:
                continue
            try:
                out, ms = layer_row(r, b, device, rng, args.skip_gemm)
            except Exception as e:   # noqa: BLE001 - the JAX tool's error field
                rows.append(_timing.error_row({"layer": r["layer"].name}, e))
                continue
            sum_us += ms * 1e3 / b
            rows.append(_timing.emit({**out, "device": label}))
        if not args.skip_whole and not only:
            x0 = _timing.seeded_images(b, config.IMAGE_SHAPE, device)
            ms = _timing.wall_ms(lambda: quant._trunk_outputs(det.graph, x0, quant=True),
                                 device)
            rows.append(_timing.emit({"layer": "WHOLE_TRUNK", "us_per_img": ms * 1e3 / b,
                                      "sum_isolated_us_per_img": sum_us, "ms": ms,
                                      "device": label}))
    return rows


def main(argv=None):
    return _timing.finish(run(bench_config(), parser().parse_args(argv)))


if __name__ == "__main__":
    main()
