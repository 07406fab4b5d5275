"""The ROI crop of the mask path: a hand-written CUDA kernel on GPU tensors,
forward and backward.

`crop_rois` replaces the TPU kernel `mask_yolo_tpu/ops/pallas_crop.py::crop_rois`
(K2). On a CUDA tensor it launches `csrc/crop_rois.cu` or raises; on a CPU
tensor it runs the plain twin `roi_align.crop_and_resize`. The twin is the
kernel's reference, never its fallback: there is no path from a CUDA tensor
to it.

For training, an fmap that requires grad goes through an
`autograd.Function` whose backward is `crop_rois_backward`: the kernel
`crop_rois_backward_f32` or `crop_rois_backward_bf16` (by the gradient's
dtype) on CUDA tensors, the twin `roi_align.crop_and_resize_backward` on CPU
tensors (for bf16 on the upcast gradient, rounded once at the end, as the
kernel sums in f32 and rounds at the store). The boxes get no gradient, as
in JAX (`roi_align.crop_and_resize` stops it).

The backward takes any C and P: the gather kernel needs C % 4 == 0 and
P <= 64, and the same entry point sends other shapes to a plain
one-thread-per-value kernel (csrc/crop_rois.cu).

The backward kernel first lists, for each band of `BWD_BAND_ROWS` fmap rows,
the sample rows that touch it, and for each ROI and column the samples
that touch the column; then each band sums only through its list.
`backward_index` and `backward_through_index` are the plain versions of the
two stages.

`crop_rois.launches` and `crop_rois_backward.launches` count kernel launches
(CPU calls do not count), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .roi_align import crop_and_resize, crop_and_resize_backward, interp_matrix

_SYMBOLS = {torch.float32: "crop_rois_f32", torch.bfloat16: "crop_rois_bf16"}
_BWD_SYMBOLS = {torch.float32: "crop_rois_backward_f32",
                torch.bfloat16: "crop_rois_backward_bf16"}
BWD_BAND_ROWS = 2    # fmap rows of a backward block (kBandRows in csrc/crop_rois.cu)


def _launch_args(n_ptrs):
    """pointers (in, boxes, [scratch,] out), B, H, W, C, K, P, stream"""
    return [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]


# The C entry points of csrc/crop_rois.cu: symbol -> (argtypes, restype).
ENTRY_POINTS = {
    "crop_rois_f32": (_launch_args(3), ctypes.c_int),
    "crop_rois_bf16": (_launch_args(3), ctypes.c_int),
    "crop_rois_backward_f32": (_launch_args(4), ctypes.c_int),
    "crop_rois_backward_bf16": (_launch_args(4), ctypes.c_int),
    "crop_rois_backward_scratch_bytes": ([ctypes.c_int] * 5, ctypes.c_size_t),
}


def bind(lib, symbols=ENTRY_POINTS):
    """{symbol: function} of a loaded crop_rois library, typed."""
    fns = {}
    for symbol in symbols:
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = ENTRY_POINTS[symbol]
        fns[symbol] = fn
    return fns


@functools.cache
def _entry_points():
    return bind(_build.load("crop_rois"))


def _launch(symbol, tensors, b, h, w, c, k, pool):
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry_points()[symbol](*(t.data_ptr() for t in tensors), b, h, w, c, k, pool,
                                     stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error {rc} (1: "
                           f"cudaErrorInvalidValue, shapes the kernel does not take)")


def _check(name, t, boxes):
    if t.device != boxes.device:
        raise ValueError(f"{name} on {t.device} but boxes on {boxes.device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")
    if t.device.type == "cuda" and not (t.is_contiguous() and boxes.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors on cuda")


def _forward(fmap, boxes, pool):
    if fmap.device.type == "cpu":
        return crop_and_resize(fmap, boxes, (pool, pool))
    b, h, w, c = fmap.shape
    k = boxes.shape[1]
    out = torch.empty((b, k, pool, pool, c), dtype=fmap.dtype, device=fmap.device)
    if out.numel():
        _launch(_SYMBOLS[fmap.dtype], (fmap, boxes, out), b, h, w, c, k, pool)
        crop_rois.launches += 1
    return out


class _CropRois(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fmap, boxes, pool):
        ctx.save_for_backward(boxes)
        ctx.fmap_hw = tuple(fmap.shape[1:3])
        return _forward(fmap, boxes, pool)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        return crop_rois_backward(grad.contiguous(), boxes, ctx.fmap_hw), None, None


def crop_rois(fmap, boxes, pool: int):
    """Bilinear crop of K ROIs per image (tf.image.crop_and_resize).

    fmap: [B, H, W, C] float32 or bfloat16; boxes: [B, K, 4] float32
    normalized (x1, y1, x2, y2). Returns [B, K, pool, pool, C] in the fmap's
    dtype. Samples outside the map are 0. Differentiable in the fmap (not
    in the boxes).
    """
    if fmap.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.shape[0] != fmap.shape[0]:
        raise ValueError(f"expected fmap [B, H, W, C] and boxes [B, K, 4], got "
                         f"{tuple(fmap.shape)} and {tuple(boxes.shape)}")
    if fmap.dtype not in _SYMBOLS:
        raise TypeError(f"fmap must be float32 or bfloat16, got {fmap.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    _check("fmap", fmap, boxes)
    if not (torch.is_grad_enabled() and fmap.requires_grad):
        return _forward(fmap, boxes, pool)
    return _CropRois.apply(fmap, boxes.detach(), pool)


def _scratch_bytes(b, h, w, k, pool):
    return _entry_points()["crop_rois_backward_scratch_bytes"](b, h, w, k, pool)


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernels' vector loads need it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def crop_rois_backward(grad, boxes, fmap_hw):
    """Gradient of `crop_rois` with respect to its fmap: grad
    [B, K, P, P, C] float32 or bfloat16, boxes [B, K, 4] float32 → d_fmap
    [B, H, W, C] in grad's dtype (sums in f32, rounded once). Any C, P and
    map size."""
    if grad.dim() != 5 or grad.shape[2] != grad.shape[3] or boxes.dim() != 3 \
            or tuple(boxes.shape) != (grad.shape[0], grad.shape[1], 4):
        raise ValueError(f"expected grad [B, K, P, P, C] and boxes [B, K, 4], got "
                         f"{tuple(grad.shape)} and {tuple(boxes.shape)}")
    if grad.dtype not in _BWD_SYMBOLS or boxes.dtype != torch.float32:
        raise TypeError(f"grad must be float32 or bfloat16 and boxes float32, got "
                        f"{grad.dtype}, {boxes.dtype}")
    _check("grad", grad, boxes)
    h, w = fmap_hw
    if grad.device.type == "cpu":
        return crop_and_resize_backward(grad.float(), boxes, (h, w)).to(grad.dtype)
    b, k, pool, _, c = grad.shape
    if k * pool == 0:   # no samples: the index kernel would launch an empty grid
        return torch.zeros((b, h, w, c), dtype=grad.dtype, device=grad.device)
    out = torch.empty((b, h, w, c), dtype=grad.dtype, device=grad.device)
    if out.numel():
        scratch = torch.empty(_scratch_bytes(b, h, w, k, pool), dtype=torch.uint8,
                              device=grad.device)
        _launch(_BWD_SYMBOLS[grad.dtype], (_aligned(grad), _aligned(boxes), scratch, out),
                b, h, w, c, k, pool)
        crop_rois_backward.launches += 1
    return out


def _tent_weights(boxes, fmap_hw, pool):
    """wy [B, K*P, H] and wx [B, K, P, W]: the crop's f32 tap weights."""
    h, w = fmap_hw
    b, k = boxes.shape[:2]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    return (interp_matrix(y1, y2, h, pool).reshape(b, k * pool, h),
            interp_matrix(x1, x2, w, pool))


def backward_index(boxes, fmap_hw, pool):
    """Plain version of the backward's index stage (`crop_index_kernel`).

    Returns (lists, first, count): lists[b][j] holds, in ascending order, the
    sample rows i = k*P + py of image b whose y taps touch fmap rows
    [j*BWD_BAND_ROWS, (j+1)*BWD_BAND_ROWS) with a non-zero weight; first and count
    [B, K, W] give, for each ROI and column x, the first px and the number of
    the consecutive samples whose x taps touch x (count 0: none)."""
    h, _ = fmap_hw
    wy, wx = _tent_weights(boxes, fmap_hw, pool)
    lists = [[torch.nonzero((wy[b, :, y0:y0 + BWD_BAND_ROWS] != 0).any(-1)).flatten()
              for y0 in range(0, h, BWD_BAND_ROWS)] for b in range(wy.shape[0])]
    hit = wx != 0                                                     # [B, K, P, W]
    touched = hit.any(2)
    first = torch.where(touched, hit.int().argmax(2), 0)
    last = pool - 1 - hit.flip(2).int().argmax(2)
    return lists, first, torch.where(touched, last - first + 1, 0)


def backward_through_index(grad, boxes, fmap_hw, index):
    """Plain version of the backward's gather (`crop_rois_backward_kernel`):
    d_fmap [B, H, W, C] summed, for each band, over its listed sample rows
    only and, for each column, over its range of samples only."""
    lists, first, count = index
    b, k, pool, _, c = grad.shape
    h, w = fmap_hw
    wy, wx = _tent_weights(boxes, fmap_hw, pool)
    px = torch.arange(pool, device=grad.device)[:, None]
    in_range = (px >= first[:, :, None]) & (px < (first + count)[:, :, None])
    wx = wx * in_range                                                # [B, K, P, W]
    g = grad.reshape(b, k * pool, pool, c)
    out = grad.new_zeros((b, h, w, c))
    for i in range(b):
        for j, rows in enumerate(lists[i]):
            band = slice(j * BWD_BAND_ROWS, min(h, (j + 1) * BWD_BAND_ROWS))
            t = torch.einsum("npx,npc->nxc", wx[i, rows // pool], g[i, rows])
            out[i, band] = torch.einsum("ny,nxc->yxc", wy[i, rows, band], t)
    return out


def index_from_scratch(scratch, b, h, w, k, pool):
    """What `crop_index_kernel` wrote into the backward's scratch (laid out
    by `carve` in csrc/crop_rois.cu), in `backward_index`'s form: (lists,
    first, count), on the CPU."""
    align16 = lambda n: -(-n // 16) * 16                               # noqa: E731
    nbands, kp, wp = -(-h // BWD_BAND_ROWS), k * pool, -(-w // 4) * 4
    raw = scratch.cpu()
    at = [0, align16(16 * b * nbands * kp), align16(4 * b * nbands), align16(16 * b * kp)]
    at = [sum(at[:i + 1]) for i in range(4)]      # lists, counts, x taps, column ranges
    words = lambda i, n: raw[at[i]:at[i] + 4 * n].view(torch.int32)   # noqa: E731
    entries = words(0, 4 * b * nbands * kp).reshape(b, nbands, kp, 4)   # i, k, wy[2]
    counts = words(1, b * nbands).reshape(b, nbands).tolist()
    lists = [[entries[i, j, :counts[i][j], 0].long() for j in range(nbands)] for i in range(b)]
    ranges = words(3, b * k * wp).reshape(b, k, wp)[..., :w]        # first | count << 16
    return lists, (ranges & 0xFFFF).long(), (ranges >> 16).long()


crop_rois.launches = 0
crop_rois_backward.launches = 0
