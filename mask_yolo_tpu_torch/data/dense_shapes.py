"""Dense multi-class synthetic dataset — the 80-class quality fixture, a copy
of `mask_yolo_tpu/data/dense_shapes.py` (the same seed gives the same
images, masks and class ids).

The BASELINE scale-out point (CocoStyleConfig: 81 classes, 416², MASK_TOP_K)
needs multi-class data with MANY instances per image to produce quality
evidence, but real COCO is not in the repository and the
reference repo ships no multi-class data at all (its VIA sets are
single-class, reference example/rice/rice_dataset.py:60-82). This
generator extends the Shapes fixture (reference dataset_shapes.py:53-180) to
that operating point:

  * class = index into a fixed `num_classes`-color palette (an RGB lattice
    with entries ≥ ~48 apart per channel); each instance is filled with its
    class's palette color plus small per-instance jitter (±12/channel), so
    the class is a crisp, learnable pixel signal — an earlier "color
    octant of a uniform-random color" scheme had so much intra-class
    variance that a from-scratch 25-epoch run scored AP ≈ 0 despite 0.41
    recall (docs/PERFORMANCE.md, r3);
  * scenes carry up to `max_instances` small shapes (default 48, well past
    CocoStyleConfig.MASK_TOP_K = 32, stressing the masks-for-top-K path);
  * same deterministic seeding, occlusion painting and GT-overlap pruning as
    the base Shapes generator;
  * optional PHOTOGRAPHIC-COMPLEXITY mode (`load_dense(textured=True)`,
    r4): per-instance multiplicative noise + luminance-gradient texture,
    smooth non-uniform backgrounds, non-GT distractor clutter, and a global
    lighting gradient — so class evidence is an *average* color that must be
    integrated over a textured, unevenly lit region instead of a flat fill.
    This is the closest feasible stand-in for the reference's photographic
    validation (its rice/food image blobs are missing from its repo,
    reference datasets/.MISSING_LARGE_BLOBS; README.md:24-34).
"""

from __future__ import annotations

import numpy as np

from .dataset import non_max_suppression
from .shapes import ShapesDataset


def color_palette(n: int) -> np.ndarray:
    """[n, 3] uint8 palette on an RGB lattice (4×4×5 = 80 for n=80),
    channel values spread over [20, 215]/[20, 212] so neighboring entries
    differ by ≥ 48 in at least one channel — separable even under the
    ±12-per-channel instance jitter."""
    rs = np.linspace(20, 215, 4)
    gs = np.linspace(20, 215, 4)
    bs = np.linspace(20, 212, 5)
    grid = np.stack(np.meshgrid(rs, gs, bs, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    assert len(grid) >= n, f"palette lattice holds {len(grid)} < {n}"
    return grid[:n].astype(np.uint8)


class DenseShapesDataset(ShapesDataset):
    """80-class dense synthetic scenes. Usage:

        d = DenseShapesDataset()
        d.load_dense(count=400, height=416, width=416, seed=0)
        d.prepare()
    """

    JITTER = 12

    def class_of(self, shape: str, color) -> int:
        """Foreground class id (1-based): nearest palette entry (shape type
        does not enter the class — it varies freely within classes)."""
        d = np.abs(self._palette.astype(np.int32)
                   - np.asarray(color, np.int32)).sum(axis=1)
        return 1 + int(np.argmin(d))

    def load_dense(self, count, height=416, width=416, seed: int | None = 0,
                   num_classes: int = 80, min_instances: int = 24,
                   max_instances: int = 48, textured: bool = False):
        self._num_fg = int(num_classes)
        self._palette = color_palette(self._num_fg)
        rng = np.random.RandomState(seed) if seed is not None else np.random
        for i in range(1, self._num_fg + 1):
            self.add_class("dense_shapes", i, f"c{i:02d}")
        for i in range(count):
            bg_color, shapes = self._random_dense_image(
                height, width, rng, min_instances, max_instances)
            info = dict(width=width, height=height, bg_color=bg_color,
                        shapes=shapes)
            if textured:
                # per-image texture seed derived OUTSIDE the spec stream, so
                # textured=True yields the exact same scene geometry (masks,
                # boxes, classes) as textured=False for the same seed
                info["texture_seed"] = (
                    ((0 if seed is None else int(seed)) * 1_000_003 + i)
                    % (2 ** 31 - 1))
            self.add_image("dense_shapes", image_id=i, path=None, **info)

    def _random_dense_image(self, height, width, rng, lo, hi):
        # background stays away from palette colors: dark gray-ish noise
        bg_color = np.array([rng.randint(228, 256) for _ in range(3)])
        n = int(rng.randint(lo, hi + 1))
        shapes, boxes = [], []
        for _ in range(n):
            shape = self.SHAPE_NAMES[rng.randint(0, len(self.SHAPE_NAMES))]
            cls = int(rng.randint(0, self._num_fg))
            jit = rng.randint(-self.JITTER, self.JITTER + 1, size=3)
            color = tuple(int(v) for v in np.clip(
                self._palette[cls].astype(np.int32) + jit, 0, 255))
            # small instances (s = half-side): 10..36 px at 416² → 0.3..1.1
            # anchor grid units, matching CocoStyleConfig's smallest priors
            s = int(rng.randint(max(4, height // 42), max(8, height // 12)))
            y = int(rng.randint(s, height - s))
            x = int(rng.randint(s, width - s))
            shapes.append((shape, color, (x, y, s)))
            boxes.append([x - s, y - s, x + s, y + s])
        # prune only near-duplicates (0.5 keeps the scene dense; the base
        # Shapes generator prunes at 0.3, dataset_shapes.py:178)
        keep = non_max_suppression(np.array(boxes), np.arange(n), 0.5)
        shapes = [s for i, s in enumerate(shapes) if i in keep]
        return bg_color, shapes

    # -- photographic-complexity rendering (textured=True) -------------------

    @staticmethod
    def _smooth_field(rng, height, width, cells: int, lo: float, hi: float):
        """[H, W] smooth random field in [lo, hi]: a coarse random grid
        bilinearly upsampled — cheap stand-in for low-frequency texture."""
        from ..utils.image import resize_bilinear

        coarse = rng.rand(cells, cells).astype(np.float32)
        field = resize_bilinear(coarse, (height, width))
        return lo + field * (hi - lo)

    @staticmethod
    def _gradient_field(rng, height, width, amp: float):
        """[H, W] linear ramp in [-amp, amp] along a random direction."""
        th = rng.rand() * 2 * np.pi
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        r = (np.cos(th) * xx / max(width - 1, 1)
             + np.sin(th) * yy / max(height - 1, 1))
        r = r - r.mean()
        return (2.0 * amp) * r / max(r.max() - r.min(), 1e-6)

    def _textured_image(self, info):
        """Render with per-instance texture, background clutter, and a global
        lighting gradient. GT geometry (masks/boxes/classes) is EXACTLY the
        flat renderer's — only pixel appearance changes, so the encoder,
        eval, and COCO export paths are untouched."""
        rng = np.random.RandomState(info["texture_seed"])
        h, w = info["height"], info["width"]

        # background: smooth low-frequency field around bg_color (±20)
        bg = np.asarray(info["bg_color"], np.float32).reshape(1, 1, 3)
        img = np.repeat(bg, h, axis=0).repeat(w, axis=1).copy()
        for c in range(3):
            img[:, :, c] += self._smooth_field(rng, h, w, 8, -20.0, 20.0)

        # distractor clutter: gray-ish non-GT shapes the detector must learn
        # to ignore (they are never added to `shapes`, so they carry no box)
        for _ in range(int(rng.randint(4, 9))):
            g = float(rng.randint(70, 200))
            col = np.clip([g + rng.randint(-14, 15) for _ in range(3)],
                          0, 255)
            s = int(rng.randint(max(4, h // 42), max(8, h // 12)))
            y = int(rng.randint(s, h - s))
            x = int(rng.randint(s, w - s))
            shape = self.SHAPE_NAMES[rng.randint(0, len(self.SHAPE_NAMES))]
            stencil = np.zeros([h, w, 1], np.uint8)
            self.draw_shape(stencil, shape, (x, y, s), 1)
            on = stencil[:, :, 0].astype(bool)
            img[on] = np.asarray(col, np.float32)

        # instances, back-to-front like the flat renderer (later occludes
        # earlier), each with multiplicative noise + a luminance gradient
        for shape, color, dims in info["shapes"]:
            stencil = np.zeros([h, w, 1], np.uint8)
            self.draw_shape(stencil, shape, dims, 1)
            on = stencil[:, :, 0].astype(bool)
            # texture cells scale with the image so instances (~h/12 px) see
            # several texture periods — the field must vary WITHIN instances
            tex = self._smooth_field(rng, h, w, max(12, h // 14), 0.85, 1.15)
            tex = tex + self._gradient_field(rng, h, w, 0.12)
            fill = (np.asarray(color, np.float32).reshape(1, 1, 3)
                    * tex[:, :, None])
            img[on] = fill[on]

        # global lighting: brightness gradient + overall gain
        gain = (1.0 + self._gradient_field(rng, h, w, 0.13)) \
            * float(rng.uniform(0.92, 1.08))
        img *= gain[:, :, None]
        # sensor-like luminance noise (shared across channels per pixel)
        img += rng.randn(h, w, 1).astype(np.float32) * 3.0
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    def load_image(self, image_id):
        info = self.image_info[image_id]
        if info.get("texture_seed") is not None:
            return self._textured_image(info)
        return super().load_image(image_id)

    def load_mask(self, image_id):
        """Same occlusion-aware rasterization as Shapes, but class ids come
        from shape×color (dropping fully-occluded instances consistently)."""
        info = self.image_info[image_id]
        if info["source"] != "dense_shapes":
            return super().load_mask(image_id)
        shapes = info["shapes"]
        count = len(shapes)
        mask = np.zeros([info["height"], info["width"], count], dtype=np.uint8)
        for i, (shape, _, dims) in enumerate(shapes):
            mask[:, :, i:i + 1] = self.draw_shape(
                mask[:, :, i:i + 1].copy(), shape, dims, 1)
        occlusion = np.logical_not(mask[:, :, -1]).astype(np.uint8)
        for i in range(count - 2, -1, -1):
            mask[:, :, i] = mask[:, :, i] * occlusion
            occlusion = np.logical_and(occlusion,
                                       np.logical_not(mask[:, :, i]))
        class_ids = np.array(
            [self.class_of(s[0], s[1]) for s in shapes], dtype=np.int32)
        visible = mask.any(axis=(0, 1))
        return mask[:, :, visible].astype(bool), class_ids[visible]
