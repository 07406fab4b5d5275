"""Native (C++) host-side kernels for the data pipeline — the port's loader
for its copy of `mask_yolo_tpu/native/image_ops.cpp`.

`image_ops.cpp` is built with g++ at first use into
`build/torch_native/image_ops_<hash>.so` at the repository root (the hash
covers the source, so an edited source is rebuilt) and bound through ctypes;
foreign calls release the GIL, so a thread-pooled loader parallelizes for
real. Nothing is built at import. Where no compiler is found or the build
fails, `available()` is False and the callers (utils/image.py) keep their
numpy implementations, which the tests hold bit-equal to these.

Set MASK_YOLO_TORCH_NATIVE=0 to force the numpy path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "torch_native"


@functools.cache
def _lib():
    """The built and loaded library, or None where it cannot be built."""
    if os.environ.get("MASK_YOLO_TORCH_NATIVE", "1") == "0":
        return None
    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so_path = BUILD_DIR / f"image_ops_{digest}.so"
        if not so_path.exists():
            tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
            subprocess.run(
                # -ffp-contract=off: no FMA contraction, so the float lerp
                # rounds exactly like the numpy twin (bitwise parity)
                ["g++", "-O3", "-march=native", "-ffp-contract=off",
                 "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)  # atomic: concurrent builds race safely
        lib = ctypes.CDLL(str(so_path))
    except (OSError, subprocess.SubprocessError):
        return None

    i64 = ctypes.c_int64
    lib.resize_bilinear_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), i64, i64, i64,
        ctypes.POINTER(ctypes.c_float), i64, i64, ctypes.c_int]
    lib.resize_bilinear_f32.restype = None
    lib.resize_nearest_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i64, i64, i64,
        ctypes.POINTER(ctypes.c_uint8), i64, i64]
    lib.resize_nearest_bytes.restype = None
    lib.polygon_mask_u8.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), i64,
        ctypes.POINTER(ctypes.c_uint8), i64, i64]
    lib.polygon_mask_u8.restype = None
    lib.circle_mask_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i64, i64, i64, i64, i64]
    lib.circle_mask_u8.restype = None
    return lib


def available() -> bool:
    """Whether the C++ twins are built and in use (builds them on the first
    call)."""
    return _lib() is not None


def _fptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resize_bilinear_f32(image: np.ndarray, out_h: int, out_w: int,
                        align_corners: bool = False) -> np.ndarray:
    """[H, W, C] any-dtype → [out_h, out_w, C] float32."""
    img = np.ascontiguousarray(image, dtype=np.float32)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.float32)
    _lib().resize_bilinear_f32(_fptr(img, ctypes.c_float), h, w, c,
                               _fptr(out, ctypes.c_float), out_h, out_w,
                               int(align_corners))
    return out


def resize_nearest(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W] or [H, W, N] any-dtype nearest resize (dtype preserved)."""
    m = np.ascontiguousarray(mask)
    squeeze = m.ndim == 2
    if squeeze:
        m = m[:, :, None]
    h, w, n = m.shape
    c_bytes = n * m.itemsize
    out = np.empty((out_h, out_w, n), m.dtype)
    _lib().resize_nearest_bytes(
        _fptr(m.view(np.uint8), ctypes.c_uint8), h, w, c_bytes,
        _fptr(out.view(np.uint8), ctypes.c_uint8), out_h, out_w)
    return out[:, :, 0] if squeeze else out


def polygon_mask(xs, ys, shape) -> np.ndarray:
    """Boolean even-odd polygon mask (same contract as
    utils.image.polygon_mask)."""
    h, w = int(shape[0]), int(shape[1])
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    ys = np.ascontiguousarray(ys, dtype=np.float64)
    out = np.empty((h, w), np.uint8)
    _lib().polygon_mask_u8(_fptr(xs, ctypes.c_double), _fptr(ys, ctypes.c_double),
                           len(xs), _fptr(out, ctypes.c_uint8), h, w)
    return out.astype(bool)


def circle_mask(shape, cx: int, cy: int, radius: int) -> np.ndarray:
    """Boolean filled-circle mask (inclusive radius, pixel centers)."""
    h, w = int(shape[0]), int(shape[1])
    out = np.zeros((h, w), np.uint8)
    _lib().circle_mask_u8(_fptr(out, ctypes.c_uint8), h, w,
                          int(cx), int(cy), int(radius))
    return out.astype(bool)
