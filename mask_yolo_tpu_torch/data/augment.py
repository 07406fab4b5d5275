"""Seeded, mask-safe augmentation pipeline — a copy of
`mask_yolo_tpu/data/augment.py` (numpy only).

Rebuilds the reference's imgaug integration
(reference myolo/myolo_utils.py:306-343): the reference accepts an
arbitrary imgaug augmenter, freezes one sampled transform per image via
`to_deterministic()`, applies it to image AND mask, but restricts mask
application to a geometric whitelist (MASK_AUGMENTERS — Fliplr/Flipud/
CropAndPad/Affine/PiecewiseAffine) through a hook.

Here the same contract is native: every op declares `affects_mask`. Geometric
ops draw ONE sample and transform image (bilinear) and mask (nearest) with
it; photometric ops touch the image only. `Sequential` owns a seeded
RandomState, so augmentation is reproducible end-to-end yet freshly resampled
on every call — i.e. per image per epoch, matching the reference's
fit_generator semantics (model.py:1047).

Usage (the `augmentation` argument of MaskYOLO.train / load_image_gt):

    aug = augment.default_augmenter(seed=7)
    # or hand-built:
    aug = augment.Sequential([
        augment.Fliplr(0.5), augment.Rot90(),
        augment.Scale((0.9, 1.1)), augment.Brightness((0.8, 1.2)),
    ], seed=7)
    model.train(train_ds, val_ds, lr, epochs, augmentation=aug)
"""

from __future__ import annotations

import numpy as np

from ..utils import image as image_ops


class Augmenter:
    """One augmentation op. Subclasses implement `apply(image, mask, rng)`
    and set `affects_mask` (True = geometric, transforms the mask with the
    same sampled parameters; False = photometric, image only — the native
    equivalent of the reference's MASK_AUGMENTERS whitelist,
    myolo_utils.py:315-321)."""

    affects_mask = False

    def apply(self, image, mask, rng):
        raise NotImplementedError

    def __call__(self, image, mask, rng=None):
        if rng is None:
            rng = np.random
        return self.apply(image, mask, rng)


class Fliplr(Augmenter):
    """Horizontal flip with probability p (imgaug.Fliplr)."""

    affects_mask = True

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def apply(self, image, mask, rng):
        if rng.rand() < self.p:
            image = np.fliplr(image).copy()
            mask = np.fliplr(mask).copy()
        return image, mask


class Flipud(Augmenter):
    """Vertical flip with probability p (imgaug.Flipud)."""

    affects_mask = True

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def apply(self, image, mask, rng):
        if rng.rand() < self.p:
            image = np.flipud(image).copy()
            mask = np.flipud(mask).copy()
        return image, mask


class Rot90(Augmenter):
    """Rotate by a random multiple of 90° drawn from `ks`. Non-square images
    only admit k ∈ {0, 2} (the output must keep the input shape)."""

    affects_mask = True

    def __init__(self, ks=(0, 1, 2, 3)):
        self.ks = tuple(int(k) % 4 for k in ks)

    def apply(self, image, mask, rng):
        ks = self.ks
        if image.shape[0] != image.shape[1]:
            ks = tuple(k for k in ks if k % 2 == 0) or (0,)
        k = ks[rng.randint(len(ks))]
        if k:
            image = np.rot90(image, k, axes=(0, 1)).copy()
            mask = np.rot90(mask, k, axes=(0, 1)).copy()
        return image, mask


class Scale(Augmenter):
    """Zoom about the image center by a factor drawn uniformly from `rng_lo_hi`
    (imgaug Affine(scale=...) with cval=0). Output keeps the input shape:
    zoom-in center-crops, zoom-out zero-pads. Image bilinear, mask nearest."""

    affects_mask = True

    def __init__(self, rng_lo_hi=(0.9, 1.1)):
        self.lo, self.hi = float(rng_lo_hi[0]), float(rng_lo_hi[1])

    def apply(self, image, mask, rng):
        s = rng.uniform(self.lo, self.hi)
        h, w = image.shape[:2]
        nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
        if (nh, nw) == (h, w):
            return image, mask
        dtype = image.dtype
        img = image_ops.resize_bilinear(image, (nh, nw))
        msk = image_ops.resize_nearest(mask, (nh / h, nw / w))
        # resize_nearest rounds its own output size; force-fit defensively
        msk = msk[:nh, :nw]
        img = self._fit(img, h, w)
        msk = self._fit(msk, h, w)
        if np.issubdtype(dtype, np.integer):
            img = np.clip(np.round(img), 0, np.iinfo(dtype).max)
        return img.astype(dtype), msk.astype(mask.dtype)

    @staticmethod
    def _fit(arr, h, w):
        """Center-crop or zero-pad `arr` (H, W, ...) to exactly (h, w)."""
        ah, aw = arr.shape[:2]
        # crop
        y0 = max(0, (ah - h) // 2)
        x0 = max(0, (aw - w) // 2)
        arr = arr[y0:y0 + h, x0:x0 + w]
        ah, aw = arr.shape[:2]
        if (ah, aw) == (h, w):
            return arr
        # pad
        py, px = h - ah, w - aw
        pad = [(py // 2, py - py // 2), (px // 2, px - px // 2)]
        pad += [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pad)


class Brightness(Augmenter):
    """Multiply pixel intensities by a factor drawn from `rng_lo_hi`
    (imgaug Multiply). Photometric: image only."""

    affects_mask = False

    def __init__(self, rng_lo_hi=(0.8, 1.2)):
        self.lo, self.hi = float(rng_lo_hi[0]), float(rng_lo_hi[1])

    def apply(self, image, mask, rng):
        m = rng.uniform(self.lo, self.hi)
        dtype = image.dtype
        out = image.astype(np.float32) * m
        if np.issubdtype(dtype, np.integer):
            out = np.clip(np.round(out), 0, np.iinfo(dtype).max)
        return out.astype(dtype), mask


class Contrast(Augmenter):
    """Scale the distance from the mean intensity by a factor from
    `rng_lo_hi` (imgaug LinearContrast). Photometric: image only."""

    affects_mask = False

    def __init__(self, rng_lo_hi=(0.8, 1.2)):
        self.lo, self.hi = float(rng_lo_hi[0]), float(rng_lo_hi[1])

    def apply(self, image, mask, rng):
        a = rng.uniform(self.lo, self.hi)
        dtype = image.dtype
        img = image.astype(np.float32)
        mean = img.mean(axis=(0, 1), keepdims=True)
        out = mean + (img - mean) * a
        if np.issubdtype(dtype, np.integer):
            out = np.clip(np.round(out), 0, np.iinfo(dtype).max)
        return out.astype(dtype), mask


class Sequential(Augmenter):
    """Apply a list of ops in order with a private seeded RandomState.

    Matches both framework call contracts: `aug(image, mask)` uses the
    internal (seeded) stream; `aug(image, mask, rng)` uses the caller's.
    """

    def __init__(self, ops, seed: int | None = 0):
        self.ops = list(ops)
        self.rng = np.random.RandomState(seed)

    @property
    def affects_mask(self):
        return any(op.affects_mask for op in self.ops)

    def apply(self, image, mask, rng):
        for op in self.ops:
            image, mask = op.apply(image, mask, rng)
        return image, mask

    def __call__(self, image, mask, rng=None):
        return self.apply(image, mask, rng if rng is not None else self.rng)


class ImgaugAdapter(Augmenter):
    """Compatibility shim for imgaug augmenters (the reference's
    `train(augmentation=)` contract, myolo_utils.py:306-343): a migrating
    user's imgaug pipeline plugs in unchanged.

    Duck-typed — anything with `augment_image` (and optionally
    `to_deterministic`) works; imgaug itself need not be importable. Per
    image, one transform is frozen via `to_deterministic()` and applied to
    the image AND, through the reference's MASK_AUGMENTERS geometric
    whitelist (enforced with `imgaug.HooksImages` when imgaug is present,
    exactly like myolo_utils.py:315-332), to each mask channel. Shape
    preservation is asserted like the reference (myolo_utils.py:335-338)."""

    affects_mask = True

    #: reference myolo_utils.py:315-321 — augmenters safe to apply to masks
    MASK_AUGMENTERS = ("Sequential", "SomeOf", "OneOf", "Sometimes",
                       "Fliplr", "Flipud", "CropAndPad", "Affine",
                       "PiecewiseAffine")

    def __init__(self, augmenter):
        if not hasattr(augmenter, "augment_image"):
            raise TypeError(
                f"{type(augmenter).__name__} has no augment_image — not an "
                "imgaug-style augmenter")
        self.augmenter = augmenter

    @classmethod
    def _activator(cls, images, augmenter, parents, default):
        return augmenter.__class__.__name__ in cls.MASK_AUGMENTERS

    def apply(self, image, mask, rng):
        det = (self.augmenter.to_deterministic()
               if hasattr(self.augmenter, "to_deterministic")
               else self.augmenter)
        image_shape, mask_shape = image.shape, mask.shape
        image = det.augment_image(image)
        hooks = None
        # drive the mask-safety whitelist only for REAL imgaug augmenters:
        # gating on "import imgaug succeeds" would pass hooks= to a
        # duck-typed augmenter whose augment_image takes no such kwarg
        if type(det).__module__.split(".")[0] == "imgaug":
            try:
                import imgaug

                hooks = imgaug.HooksImages(activator=self._activator)
            except ImportError:
                pass
        mask_u8 = mask.astype(np.uint8)
        mask = (det.augment_image(mask_u8, hooks=hooks) if hooks is not None
                else det.augment_image(mask_u8))
        if image.shape != image_shape or mask.shape != mask_shape:
            raise ValueError(
                "imgaug augmentation changed the image/mask shape — use "
                "shape-preserving augmenters (reference myolo_utils.py:335-338)")
        return image, mask.astype(bool)


def as_augmenter(augmentation):
    """Normalize any accepted `augmentation=` value to a (image, mask) ->
    (image, mask) callable: native Augmenters and bare callables pass
    through; imgaug-style objects (duck-typed on `augment_image`) are
    wrapped in ImgaugAdapter."""
    if augmentation is None or isinstance(augmentation, Augmenter):
        return augmentation
    # check augment_image BEFORE callable: modern imgaug augmenters are
    # themselves callable (aug(images=...)), but not with (image, mask)
    if hasattr(augmentation, "augment_image"):
        return ImgaugAdapter(augmentation)
    if callable(augmentation):
        return augmentation
    raise TypeError(
        f"augmentation={type(augmentation).__name__!r} is neither callable "
        "nor an imgaug-style augmenter (no augment_image)")


def default_augmenter(seed: int | None = 0) -> Sequential:
    """The flip/rot90/scale/brightness set named by the round-1 review:
    a reasonable default for small datasets (it produced the +0.06 AP50
    jump recorded in docs/PERFORMANCE.md for Shapes)."""
    return Sequential([
        Fliplr(0.5),
        Rot90(),
        Scale((0.9, 1.1)),
        Brightness((0.85, 1.15)),
    ], seed=seed)
