"""Host-side image utilities (numpy) — a copy of `mask_yolo_tpu/utils/image.py`
with its numpy paths only.

The JAX package switches to host C++ twins (`mask_yolo_tpu/native/`) when
they build; its own tests hold them bit-equal to these numpy versions. The
C++ twins are not ported yet (ROADMAP Queue 1, augmentation, pooled data
workers and native image ops).
Resize (skimage semantics), nearest-neighbour mask zoom (scipy semantics),
and the rasterizers the Shapes dataset draws with.
"""

from __future__ import annotations

import numpy as np


def _resize_coords(out_size: int, in_size: int, align_corners: bool = False):
    """Sample coordinates for resizing, matching skimage.transform.resize
    (mode='constant', anti_aliasing=False), i.e. half-pixel centers."""
    if align_corners and out_size > 1:
        return np.linspace(0.0, in_size - 1.0, out_size)
    scale = in_size / out_size
    return (np.arange(out_size) + 0.5) * scale - 0.5


def resize_bilinear(image: np.ndarray, output_shape, align_corners: bool = False):
    """Bilinear resize with edge clamping (half-pixel centers by default).

    image: [H, W] or [H, W, C] float or uint8.
    Returns float64/float32 array of shape output_shape (+ channels).
    """
    image = np.asarray(image)
    in_h, in_w = image.shape[:2]
    out_h, out_w = int(output_shape[0]), int(output_shape[1])
    if (in_h, in_w) == (out_h, out_w):
        return image.astype(np.float32, copy=True)

    ys = np.clip(_resize_coords(out_h, in_h, align_corners), 0, in_h - 1)
    xs = np.clip(_resize_coords(out_w, in_w, align_corners), 0, in_w - 1)

    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (ys - y0).astype(np.float32)
    wx = (xs - x0).astype(np.float32)

    img = image.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    else:
        squeeze = False

    top = img[y0][:, x0] * (1 - wx)[None, :, None] + img[y0][:, x1] * wx[None, :, None]
    bot = img[y1][:, x0] * (1 - wx)[None, :, None] + img[y1][:, x1] * wx[None, :, None]
    out = top * (1 - wy)[:, None, None] + bot * wy[:, None, None]
    return out[:, :, 0] if squeeze else out


def resize_nearest(mask: np.ndarray, zoom):
    """Nearest-neighbour zoom matching scipy.ndimage.zoom(order=0) semantics
    (reference resize_mask, myolo_utils.py:393-410): output size is
    round(in * zoom) and sample points are taken at uniform spacing."""
    mask = np.asarray(mask)
    in_h, in_w = mask.shape[:2]
    out_h = int(round(in_h * zoom[0]))
    out_w = int(round(in_w * zoom[1]))
    if (out_h, out_w) == (in_h, in_w):
        return mask.copy()
    # scipy order=0: coordinate mapping in_coord = out_coord * (in/out), rounded
    ys = np.clip(np.round(np.arange(out_h) * (in_h / out_h)).astype(np.int64), 0, in_h - 1)
    xs = np.clip(np.round(np.arange(out_w) * (in_w / out_w)).astype(np.int64), 0, in_w - 1)
    return mask[np.ix_(ys, xs)] if mask.ndim == 2 else mask[np.ix_(ys, xs)]


def resize_image(image: np.ndarray, net_image_shape):
    """Resize image to the network input shape, returning (image, scale).

    Mirrors the reference resize_image (myolo_utils.py:369-390): per-axis
    scale factors, bilinear interpolation, dtype preserved.
    """
    image_dtype = image.dtype
    h, w = image.shape[:2]
    scale = [net_image_shape[0] / h, net_image_shape[1] / w]
    if scale != [1, 1]:
        image = resize_bilinear(image, (round(h * scale[0]), round(w * scale[1])))
    return image.astype(image_dtype), scale


def resize_mask(mask: np.ndarray, scale):
    """Nearest-neighbour mask resize by per-axis scale (reference
    myolo_utils.py:393-410)."""
    return resize_nearest(mask, (scale[0], scale[1]))


# ---------------------------------------------------------------------------
# Rasterization primitives (replace cv2.rectangle / cv2.circle / cv2.fillPoly
# used by the Shapes dataset, reference example/shapes/dataset_shapes.py:121-135)
# ---------------------------------------------------------------------------


def fill_rectangle(image: np.ndarray, x0: int, y0: int, x1: int, y1: int, color):
    """Filled axis-aligned rectangle with inclusive corners (cv2 semantics)."""
    h, w = image.shape[:2]
    xa, xb = sorted((int(x0), int(x1)))
    ya, yb = sorted((int(y0), int(y1)))
    xa, xb = max(xa, 0), min(xb, w - 1)
    ya, yb = max(ya, 0), min(yb, h - 1)
    if xa > xb or ya > yb:
        return image
    image[ya : yb + 1, xa : xb + 1] = color
    return image


def fill_circle(image: np.ndarray, cx: int, cy: int, radius: int, color):
    """Filled circle: pixels whose centers are within `radius` (inclusive)."""
    h, w = image.shape[:2]
    yy, xx = np.ogrid[:h, :w]
    mask = (xx - int(cx)) ** 2 + (yy - int(cy)) ** 2 <= int(radius) ** 2
    image[mask] = color
    return image


def fill_polygon(image: np.ndarray, xs, ys, color):
    """Filled polygon via even-odd scanline test (replaces cv2.fillPoly /
    skimage.draw.polygon used by the VIA loaders, rice_dataset.py:135-159)."""
    h, w = image.shape[:2]
    mask = polygon_mask(xs, ys, (h, w))
    image[mask] = color
    return image


def polygon_mask(xs, ys, shape) -> np.ndarray:
    """Boolean mask of a filled polygon (vertices in pixel coordinates).

    Even-odd rule, evaluated at pixel centers, vectorized over rows.
    """
    h, w = shape
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    n = len(xs)
    mask = np.zeros((h, w), dtype=bool)
    if n < 3:
        return mask
    px = np.arange(w) + 0.0
    for row in range(h):
        py = float(row)
        inside = np.zeros(w, dtype=bool)
        j = n - 1
        for i in range(n):
            yi, yj = ys[i], ys[j]
            xi, xj = xs[i], xs[j]
            cond = (yi > py) != (yj > py)
            if cond:
                x_int = (xj - xi) * (py - yi) / (yj - yi) + xi
                inside ^= px < x_int
            j = i
        mask[row] = inside
    return mask
