"""YOLO grid-target encoding, vectorized — a copy of
`mask_yolo_tpu/data/encoder.py`.

Replaces the per-instance Python loops of the reference BatchGenerator
(reference myolo/myolo_utils.py:769-820): each GT box is mapped to the
grid cell containing its center and the anchor prior with the best wh-IoU,
then (cx, cy, w, h) in grid units, conf=1 and a one-hot class are written at
[gy, gx, anchor]. Here the whole batch is encoded by ONE numpy fancy-index
scatter over every (image, instance) pair — no per-image or per-instance
Python loops on the training hot path.

Semantics notes (verified against the reference):
 * If several GT boxes land on the same (cell, anchor), the *last* one wins
   (the reference overwrites in loop order). numpy's advanced-index assignment
   also assigns in index order, so a single ordered scatter preserves this
   (the JAX package's tests hold the scatter to a per-instance loop).
 * true_boxes holds up to TRUE_BOX_BUFFER boxes in grid units; the reference
   wraps the write index modulo the buffer, which matters only if an image
   has more GT than the buffer — preserved via the per-image ordinal % buffer.
 * Boxes whose center cell falls outside the grid are dropped (the reference
   checks grid_x < GRID_W and grid_y < GRID_H).
"""

from __future__ import annotations

import numpy as np


def wh_iou(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """IoU between origin-anchored (w, h) boxes [N, 2] and anchors [A, 2].

    Equivalent to the reference's bbox_iou(BoundBox(0,0,w,h), anchor)
    (myolo_utils.py:187-198 with both boxes at the origin).
    """
    inter = np.minimum(wh[:, None, 0], anchors[None, :, 0]) * np.minimum(
        wh[:, None, 1], anchors[None, :, 1]
    )
    union = wh[:, 0:1] * wh[:, 1:2] + (anchors[:, 0] * anchors[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def encode_batch(gt_boxes: np.ndarray, gt_class_ids: np.ndarray, config):
    """Vectorized-over-batch encoding: [B, G, 4] px boxes + [B, G] ids →
    (yolo_target [B, gh, gw, nb, 5+C], true_boxes [B, 1, 1, 1, T, 4]).

    One fancy-index scatter across all (image, instance) pairs; later
    instances overwrite earlier ones at a colliding (cell, anchor) exactly
    like the reference's write loop (myolo_utils.py:769-820).
    """
    gh, gw, nb = config.GRID_H, config.GRID_W, config.N_BOX
    nc = config.NUM_CLASSES
    tbuf = config.TRUE_BOX_BUFFER
    # IMAGE_SHAPE is [H, W, 3] (config.py:82) — the device decoder
    # (ops/boxes.py:54-59) normalizes x by GRID_W and y by GRID_H, so the
    # encoder must convert with the matching per-axis pixel sizes.
    img_h = float(config.IMAGE_SHAPE[0])
    img_w = float(config.IMAGE_SHAPE[1])
    anchors = config.anchors_wh  # [A, 2] grid units

    gt_boxes = np.asarray(gt_boxes, dtype=np.float32)
    gt_class_ids = np.asarray(gt_class_ids)
    b = gt_boxes.shape[0]

    targets = np.zeros((b, gh, gw, nb, 5 + nc), dtype=np.float32)
    tboxes = np.zeros((b, 1, 1, 1, tbuf, 4), dtype=np.float32)

    valid = np.abs(gt_boxes).sum(axis=-1) > 0  # [B, G]
    if not valid.any():
        return targets, tboxes
    if int(gt_class_ids[valid].max()) >= nc:
        raise ValueError(
            f"GT class id {int(gt_class_ids[valid].max())} out of range for "
            f"NUM_CLASSES={nc} (ids must be < NUM_CLASSES)")

    # centers and sizes in grid units (reference divides by IMAGE/GRID per
    # axis: myolo_utils.py:778-790)
    cx = 0.5 * (gt_boxes[..., 0] + gt_boxes[..., 2]) / (img_w / gw)  # [B, G]
    cy = 0.5 * (gt_boxes[..., 1] + gt_boxes[..., 3]) / (img_h / gh)
    w = (gt_boxes[..., 2] - gt_boxes[..., 0]) / (img_w / gw)
    h = (gt_boxes[..., 3] - gt_boxes[..., 1]) / (img_h / gh)

    gx = np.floor(cx).astype(np.int64)
    gy = np.floor(cy).astype(np.int64)
    in_grid = valid & (gx < gw) & (gy < gh) & (gx >= 0) & (gy >= 0)

    # row-major nonzero: image-major, instance order preserved within image
    bi, gi = np.nonzero(in_grid)
    if bi.size == 0:
        return targets, tboxes

    cx_v, cy_v = cx[bi, gi], cy[bi, gi]
    w_v, h_v = w[bi, gi], h[bi, gi]
    gx_v, gy_v = gx[bi, gi], gy[bi, gi]
    cls_v = gt_class_ids[bi, gi].astype(np.int64)

    best_anchor = np.argmax(wh_iou(np.stack([w_v, h_v], axis=1), anchors), axis=1)

    rows = np.zeros((bi.size, 5 + nc), dtype=np.float32)
    rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3] = cx_v, cy_v, w_v, h_v
    rows[:, 4] = 1.0
    rows[np.arange(bi.size), 5 + cls_v] = 1.0
    targets[bi, gy_v, gx_v, best_anchor] = rows

    # per-image ordinal of each instance (bi is sorted) → modulo-wrapped slot
    ordinal = np.arange(bi.size) - np.searchsorted(bi, bi)
    tboxes[bi, 0, 0, 0, ordinal % tbuf] = np.stack([cx_v, cy_v, w_v, h_v], axis=1)

    return targets, tboxes

