"""Ahead-of-time export: the detect pipeline as a `torch.export` artifact —
port of `mask_yolo_tpu/export.py`.

`torch.export.export` traces the image → boxes + masks pipeline
(`pipelines.detect_outputs`, or the int8 `QuantizedDetector.detect_fn`) once
into an `ExportedProgram` whose weights travel inside it, and
`torch.export.save` serializes it. A serving process then needs the port's
op modules and torch: no config subclass, no weight file, no model code, no
re-trace. The three hand-written kernels are `torch.library` custom ops
(`ops/roi_crop.py`, `ops/ds_block.py`, `ops/mask_fused.py`), so the program
records them as op calls and launches them when it runs, on the card as on
the CPU (where each op runs its plain version). Loading runs neither
`torch.compile` nor AOTInductor: the program executes the same ops as the
live path, and on the CPU gives the live path's result bit for bit
(tests/test_torch_export.py).

The batch dimension is symbolic by default, traced on an example batch of 2
(export specializes sizes 0 and 1); `batch_size=` pins it. It is a
`Dim.DYNAMIC` hint, not a named `Dim`: on the card the CUDA ops' 32-bit
index checks bound the batch from above, a bound that a named Dim refuses
to trace and the hint keeps in the program's range; the hint still fails
the export if the batch would be specialized to one size. Input is uint8 by
default (the serving wire format, normalized in the program) or float32 in
[0, 1].

The program runs where it was traced. `platforms` lists the device types it
may be loaded onto ("cpu", "cuda"; default: the one it was traced on), and
`ExportedDetector.load(path, device=)` moves it there with
`torch.export.passes.move_to_device_pass`.

File format (one self-contained file, the JAX package's layout with the
port's own magic, `model` and a `torch_version` key in place of
`jax_version`, so that each package refuses the other's files):

    magic  b"MYTORCHX"            8 bytes
    header length                 8 bytes little-endian
    header JSON (utf-8)           model/config metadata, see export_detect_fn
    payload                       torch.export.save bytes
"""

from __future__ import annotations

import io
import json
import struct
import types

import numpy as np
import torch

from . import pipelines
from .ops import ds_block, mask_fused, roi_crop  # noqa: F401  (registers the custom ops)

_MAGIC = b"MYTORCHX"
_FORMAT_VERSION = 1
_MODEL = "mask_yolo_tpu_torch.detect"
_PLATFORMS = ("cpu", "cuda")
EXAMPLE_BATCH = 2   # export specializes batch sizes 0 and 1, so trace on 2


class _Detect(torch.nn.Module):
    """images → detect dict, as an nn.Module for torch.export. `net`, when
    given, is a submodule, so its weights are the program's parameters and
    buffers; the int8 path's weights are tensors the function closes over,
    which the program keeps as constants."""

    def __init__(self, fn, net=None):
        super().__init__()
        self.fn = fn
        self.net = net

    def forward(self, images):
        return self.fn(images)


def export_detect(net, config, *, batch_size=None, input_dtype="uint8", platforms=None):
    """Trace the float (f32/bf16) detect pipeline of a `MaskYoloNet` (eval
    mode, on the device to trace on). Returns (program, header)."""
    return export_detect_fn(
        lambda images: pipelines.detect_outputs(net, images, config), config,
        batch_size=batch_size, input_dtype=input_dtype, platforms=platforms,
        compute_path=config.COMPUTE_DTYPE, net=net)


def export_detect_fn(fn, config, *, batch_size=None, input_dtype="uint8", platforms=None,
                     compute_path="float32", net=None, device=None):
    """Trace any images → detect-dict callable: the float path above and the
    int8 path (`QuantizedDetector.detect_fn`, whose packed int8 weights the
    program keeps as constants; run it once before, so that they are packed
    outside the trace).

    batch_size: int to pin the batch; None (default) exports a symbolic
    batch dimension, so one artifact serves any B >= 1.
    input_dtype: "uint8" (the serving contract; normalized in the program) or
    "float32" (the caller normalizes to [0, 1]).
    platforms: the device types the artifact may be loaded onto (a subset of
    "cpu", "cuda"); None: the one it is traced on.
    device: where to trace (default: `net`'s device, else the card; the
    CPU only when asked for).

    Returns (program, header_dict)."""
    if input_dtype not in ("uint8", "float32"):
        raise ValueError(f"input_dtype must be uint8/float32, got {input_dtype}")
    if device is None:
        device = next(net.parameters()).device if net is not None else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    platforms = [device.type] if platforms is None else list(platforms)
    if not set(platforms) <= set(_PLATFORMS) or not platforms:
        raise ValueError(f"platforms must be a subset of {_PLATFORMS}, got {platforms}")
    h, w, c = config.IMAGE_SHAPE
    b = EXAMPLE_BATCH if batch_size is None else int(batch_size)
    example = torch.zeros((b, h, w, c), dtype=getattr(torch, input_dtype), device=device)
    dynamic = ({"images": {0: torch.export.Dim.DYNAMIC(min=1)}} if batch_size is None
               else None)
    with torch.no_grad():
        program = torch.export.export(_Detect(fn, net), (example,), dynamic_shapes=dynamic)

    header = {
        "format_version": _FORMAT_VERSION,
        "model": _MODEL,
        "config_name": getattr(config, "NAME", "?"),
        "num_classes": int(config.NUM_CLASSES),
        "image_shape": [int(h), int(w), int(c)],
        "detection_max_instances": int(config.DETECTION_MAX_INSTANCES),
        "batch_size": None if batch_size is None else int(batch_size),
        "labels": list(getattr(config, "LABELS", []) or []),
        "compute_path": compute_path,
        "input_dtype": input_dtype,
        "platforms": platforms,
        "traced_on": str(device),
        "torch_version": torch.__version__,
        "outputs": ["boxes [B,K,4] f32 pixel xyxy", "classes [B,K] i32",
                    "scores [B,K] f32", "masks [B,K,H,W] bool",
                    "valid [B,K] bool"],
    }
    return program, header


def custom_op_counts(program) -> dict:
    """{op name: call nodes} of the port's custom ops in a program's graph."""
    counts = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("mask_yolo_tpu_torch."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def save_exported(program, header, path):
    """Serialize a program + header to the container format above."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    head = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        f.write(buf.getvalue())


class ExportedDetector:
    """A serving-ready detector loaded from an export file.

    It has the `detect_batch(images) -> dict` contract of
    MaskYOLO/QuantizedDetector, so it drops into serve.BatchingExecutor (with
    `serve_config()` for the config): a deployment process that imports this
    module and torch."""

    def __init__(self, program, header, device):
        self.program = program
        self.header = header
        self.device = torch.device(device)
        self._module = program.module()

    @classmethod
    def load(cls, path, device=None):
        """Read an artifact; `device` (default: where it was traced) moves
        the program there, if the header's platforms allow its type."""
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a mask_yolo_tpu_torch export "
                                 f"(bad magic {magic!r})")
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
            if header.get("format_version") != _FORMAT_VERSION or header.get("model") != _MODEL:
                raise ValueError(f"{path}: unsupported artifact (format_version "
                                 f"{header.get('format_version')}, model {header.get('model')})")
            program = torch.export.load(io.BytesIO(f.read()))
        traced = torch.device(header["traced_on"])
        device = traced if device is None else torch.device(device)
        if device.type not in header["platforms"]:
            raise ValueError(f"{path}: exported for {header['platforms']}, not {device.type} "
                             f"(export with platforms=[..., {device.type!r}])")
        if device != traced:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
        return cls(program, header, device)

    def serve_config(self, batch_size=None):
        """A config shim (IMAGE_SHAPE / BATCH_SIZE / LABELS from the header)
        for serve.BatchingExecutor, so a deployment process serves from the
        artifact with no Config subclass."""
        fixed = self.header["batch_size"]
        if batch_size is None:
            batch_size = fixed or 8
        elif fixed is not None and batch_size != fixed:
            raise ValueError(f"artifact pins batch_size={fixed}, requested {batch_size}")
        return types.SimpleNamespace(
            IMAGE_SHAPE=list(self.header["image_shape"]),
            BATCH_SIZE=int(batch_size),
            LABELS=list(self.header.get("labels", [])))

    @torch.inference_mode()
    def detect_batch(self, images):
        """[B, H, W, 3] uint8 (or float32 in [0, 1] if exported so), numpy
        or tensor → the fixed-shape dict of tensors on the program's device
        (see pipelines.detect_outputs)."""
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images))
        want = getattr(torch, self.header["input_dtype"])
        if images.dtype != want:
            if want == torch.uint8 and images.is_floating_point():
                # callers holding [0, 1] floats: quantize to the wire dtype
                images = torch.clamp(images * 255.0 + 0.5, 0, 255).to(torch.uint8)
            elif want == torch.float32 and not images.is_floating_point():
                # float32 artifacts expect [0, 1] input (pipelines.images_f32
                # passes floats through): integer input is normalized here,
                # not bare-cast, or the graph would see 0-255 values
                images = images.to(torch.float32) / 255.0
            else:
                images = images.to(want)
        fixed = self.header["batch_size"]
        if fixed is not None and images.shape[0] != fixed:
            raise ValueError(
                f"artifact was exported with batch_size={fixed}, got batch {images.shape[0]} "
                f"(export with batch_size=None for a symbolic batch dimension)")
        return self._module(images.to(self.device))
