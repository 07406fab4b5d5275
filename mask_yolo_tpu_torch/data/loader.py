"""GT loading & geometry: dataset sample → fixed-shape training arrays — a
copy of `mask_yolo_tpu/data/loader.py`, without `augmentation=`.

Host-side counterpart of the reference's load_image_gt / extract_bboxes
(reference myolo/myolo_utils.py:247-366). Everything returned here is
fixed-shape (padded to MAX_GT_INSTANCES / TRUE_BOX_BUFFER) so the device-side
pipeline can be compiled once — the reference instead carries ragged arrays
into TF ops (SURVEY.md §7 "Hard parts").
"""

from __future__ import annotations

import numpy as np

from ..utils import image as image_ops


def extract_bboxes(mask: np.ndarray) -> np.ndarray:
    """Bounding boxes [N, (x1, y1, x2, y2)] from instance masks [H, W, N].

    Matches the reference (myolo_utils.py:247-271): x2/y2 are exclusive,
    all-empty masks produce a zero box. Vectorized over instances.
    """
    mask = np.asarray(mask)
    n = mask.shape[-1]
    boxes = np.zeros([n, 4], dtype=np.int32)
    if n == 0:
        return boxes
    any_x = mask.any(axis=0)  # [W, N]: columns containing the instance
    any_y = mask.any(axis=1)  # [H, N]: rows containing the instance
    for i in range(n):
        xs = np.where(any_x[:, i])[0]
        ys = np.where(any_y[:, i])[0]
        if xs.shape[0]:
            boxes[i] = [xs[0], ys[0], xs[-1] + 1, ys[-1] + 1]
    return boxes


def load_image_gt(dataset, config, image_id, augment=False, augmentation=None,
                  use_mini_mask=None, rng=None):
    """Load one image + GT and resize to the network input shape.

    Returns (image [H,W,3] uint8, class_ids [N] int32, boxes [N,4] int32 xyxy
    pixels, masks [H,W,N] bool) — ragged in N, like the reference
    (myolo_utils.py:274-366). Use `pack_gt` to fix the shapes.

    rng: np.random.RandomState driving the `augment` flip (and GT
    subsampling in pack_gt when threaded there); None falls back to the
    global stream. Pass a seeded state for deterministic pipelines.
    """
    if augmentation is not None:
        raise NotImplementedError(
            "augmentation= is not ported yet (ROADMAP Queue 1, augmentation, "
            "pooled data workers and native image ops)")
    if rng is None:
        rng = np.random
    image = dataset.load_image(image_id)
    mask, class_ids = dataset.load_mask(image_id)
    image, scale = image_ops.resize_image(image, config.IMAGE_SHAPE)
    mask = image_ops.resize_mask(mask, scale)

    if augment:
        # horizontal flip with p=0.5 (reference: myolo_utils.py:308-312)
        if rng.randint(0, 2):
            image = np.fliplr(image)
            mask = np.fliplr(mask)

    # Drop instances whose mask vanished during resize (myolo_utils.py:345-349)
    _idx = np.sum(mask, axis=(0, 1)) > 0
    mask = mask[:, :, _idx]
    class_ids = class_ids[_idx]
    bbox = extract_bboxes(mask)
    if use_mini_mask or (use_mini_mask is None and config.USE_MINI_MASK):
        mask = minimize_mask(bbox, mask, tuple(config.MINI_MASK_SHAPE))
    return image, class_ids, bbox, mask


def minimize_mask(bbox, mask, mini_shape) -> np.ndarray:
    """Crop each instance mask to its box and resize to `mini_shape`
    (reference myolo_utils.py:413-430). bbox is (x1, y1, x2, y2) with
    exclusive x2/y2 as produced by extract_bboxes. Returns bool
    [mh, mw, N]."""
    mask = np.asarray(mask)
    n = mask.shape[-1]
    mini = np.zeros(tuple(mini_shape) + (n,), dtype=bool)
    for i in range(n):
        x1, y1, x2, y2 = (int(v) for v in bbox[i][:4])
        m = mask[y1:y2, x1:x2, i].astype(np.float32)
        if m.size == 0:
            raise ValueError("Invalid bounding box with area of zero")
        m = image_ops.resize_bilinear(m[..., None], mini_shape)[..., 0]
        mini[:, :, i] = np.around(m).astype(bool)
    return mini


def pack_gt(class_ids, boxes, masks, config, rng=None):
    """Pad ragged GT to fixed shapes for jit: returns
    (class_ids [G], boxes [G,4] float32 px, masks [H,W,G] bool) with
    G = MAX_GT_INSTANCES; excess instances are randomly subsampled
    (reference BatchGenerator: myolo_utils.py:760-767). rng: optional
    seeded RandomState for the subsample."""
    if rng is None:
        rng = np.random
    g = config.MAX_GT_INSTANCES
    n = class_ids.shape[0]
    if n > g:
        ids = rng.choice(np.arange(n), g, replace=False)
        class_ids = class_ids[ids]
        boxes = boxes[ids]
        masks = masks[:, :, ids]
        n = g
    out_ids = np.zeros((g,), dtype=np.int32)
    out_boxes = np.zeros((g, 4), dtype=np.float32)
    h, w = (config.MINI_MASK_SHAPE if config.USE_MINI_MASK
            else config.IMAGE_SHAPE[:2])
    out_masks = np.zeros((h, w, g), dtype=bool)
    out_ids[:n] = class_ids
    out_boxes[:n] = boxes
    out_masks[:, :, : masks.shape[-1]] = masks
    return out_ids, out_boxes, out_masks
