"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/torch_kernels/lib<name>-<hash>.so` at the repository root, at
first use. The hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def build(name: str, csrc: Path = CSRC) -> Path:
    """Compile <csrc>/<name>.cu unless its library is already built. nvcc's
    output (ptxas register and spill counts) goes to <library>.log."""
    from torch.utils.cpp_extension import CUDA_HOME

    src = Path(csrc) / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if lib.exists():
        return lib
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
                           "-o", str(tmp), str(src)], capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        return _load(name)
