"""Anchor-prior generation: k-means in IoU distance over GT (w, h) — a copy of
`mask_yolo_tpu/utils/anchors.py`.

Rebuilds the reference's anchor-generator notebook
(reference example/{rice,food}/03_anchor_generator.ipynb, cells 3-9):
YOLOv2-style k-means where the distance between a box and a centroid is
1 − IoU(wh, centroid), centroids scaled to grid units (× GRID/1.0 from
normalized w,h), with an avg-IoU elbow sweep over k. Exposed both as a
library (used by tools/gen_anchors.py CLI) and importable for tests.
"""

from __future__ import annotations

import numpy as np


def wh_iou_matrix(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """IoU between origin-anchored boxes [N, 2] and centroids [K, 2]."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0])
             * np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] + \
        (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def kmeans_anchors(wh: np.ndarray, k: int, seed: int = 0, iters: int = 1000):
    """k-means with distance = 1 − IoU. wh: [N, 2] normalized (0..1) box
    sizes. Returns (centroids [k, 2] sorted by area, avg_iou)."""
    wh = np.asarray(wh, dtype=np.float64)
    n = wh.shape[0]
    assert n >= k, f"need at least {k} boxes, got {n}"
    rng = np.random.RandomState(seed)
    centroids = wh[rng.choice(n, k, replace=False)]
    prev = np.full(n, -1)
    for _ in range(iters):
        iou = wh_iou_matrix(wh, centroids)
        assign = iou.argmax(axis=1)
        if np.array_equal(assign, prev):
            break
        prev = assign
        for c in range(k):
            members = wh[assign == c]
            if len(members):
                centroids[c] = members.mean(axis=0)
    avg_iou = float(wh_iou_matrix(wh, centroids).max(axis=1).mean())
    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    return centroids[order], avg_iou


def boxes_to_wh(boxes: np.ndarray, image_shape) -> np.ndarray:
    """GT pixel boxes [N, (x1, y1, x2, y2)] → normalized (w, h) pairs."""
    boxes = np.asarray(boxes, dtype=np.float64)
    # image_shape is [H, W, ...]
    w = (boxes[:, 2] - boxes[:, 0]) / image_shape[1]
    h = (boxes[:, 3] - boxes[:, 1]) / image_shape[0]
    keep = (w > 0) & (h > 0)
    return np.stack([w[keep], h[keep]], axis=1)


def gen_anchors(wh: np.ndarray, k: int, grid: int = 7, seed: int = 0):
    """Normalized (w, h) pairs → k anchors in grid units + avg IoU
    (notebook cell 9: centroids × (224/32) = × grid)."""
    centroids, avg_iou = kmeans_anchors(wh, k, seed=seed)
    return centroids * grid, avg_iou


def sweep_k(wh: np.ndarray, k_max: int = 10, seed: int = 0):
    """avg-IoU elbow data for k = 1..k_max (notebook cells 5, 9)."""
    ks, ious = [], []
    for k in range(1, min(k_max, len(wh)) + 1):
        _, avg = kmeans_anchors(wh, k, seed=seed)
        ks.append(k)
        ious.append(avg)
    return ks, ious


def anchors_from_dataset(dataset, config, k: int = 5, seed: int = 0):
    """End-to-end: dataset → GT boxes → anchors in grid units."""
    from ..data.loader import load_image_gt

    all_wh = []
    for image_id in dataset.image_ids:
        _, _, boxes, _ = load_image_gt(dataset, config, image_id)
        all_wh.append(boxes_to_wh(boxes, config.IMAGE_SHAPE))
    wh = np.concatenate(all_wh, axis=0)
    return gen_anchors(wh, k, grid=config.GRID_W, seed=seed)
