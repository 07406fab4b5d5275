"""Exact int8 arithmetic shared by the int8 path (quant.py) and the plain
versions of its kernels (ds_block.py, mask_fused.py).

`quantize` is `quant._quantize_act` of the JAX package bit for bit:
inv = f32(1) / f32(scale), then round half to even (`torch.round`, like
`jnp.round`), then clip to ±127; a vector scale (one value per channel)
broadcasts over the last axis. `int_mm` is an int8 matrix product with
int32 accumulation, exact on every device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def inv_scale(scale):
    """f32(1) / f32(scale): a Python float (exact in f32) for a scalar, an
    f32 array for a vector."""
    inv = np.float32(1.0) / np.asarray(scale, np.float32)
    return inv if inv.ndim else float(inv)


_VECTORS = {}   # (id of the array, device, inverse?) → (the array, its tensor)


def scale_tensor(scale, device, inverse: bool = False):
    """A per-channel scale vector (numpy) or its f32 inverse as a tensor on
    `device`, cached while the array lives on in a layer graph."""
    key = (id(scale), str(device), inverse)
    hit = _VECTORS.get(key)
    if hit is None or hit[0] is not scale:
        if len(_VECTORS) > 4096:
            _VECTORS.clear()
        arr = inv_scale(scale) if inverse else np.asarray(scale, np.float32)
        with torch.inference_mode(False):   # a plain tensor, usable under autograd
            hit = (scale, torch.as_tensor(arr, device=device))
        _VECTORS[key] = hit
    return hit[1]


def quantize(x, scale):
    """f32 tensor → int8 at `scale`: a scalar, or a numpy vector over the
    last axis."""
    inv = scale_tensor(scale, x.device, True) if isinstance(scale, np.ndarray) \
        else inv_scale(scale)
    return quantize_inv(x, inv)


def quantize_inv(x, inv):
    """f32 tensor → int8 by its inverse scale `inv` (inv_scale's value: a
    float, or a tensor over the last axis)."""
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def int_mm(a, b):
    """int8 [M, K] @ int8 [K, N] → int32 [M, N] through `torch._int_mm`.

    On CUDA `_int_mm` needs M > 16 and K, N multiples of 8. K and N are
    zero-padded to that on every device, M to 17 rows on CUDA only (zero rows
    and columns add exact zeros), which covers the stem (K = 27) and
    `conv_23` (N = 3·(5+C)). M carries the batch, so a traced program
    (export.py) decides its padding by a comparison that the batch's range
    settles, not by a guard on the batch. cuBLASLt's int8 GEMM also wants
    `b` column-major there."""
    m, k = a.shape
    n = b.shape[1]
    kp, n8 = _round8(k), _round8(n)
    if kp != k:
        a = F.pad(a, (0, kp - k))
        b = F.pad(b, (0, 0, 0, kp - k))
    if n8 != n:
        b = F.pad(b, (0, n8 - n))
    if a.is_cuda and m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    b = b.t().contiguous().t() if b.is_cuda else b.contiguous()
    return torch._int_mm(a.contiguous(), b)[:m, :n]
