"""Detection/instance-segmentation evaluation metrics (host-side NumPy) — a
copy of `mask_yolo_tpu/utils/metrics.py`.

The reference delegates these to the external matterport ``mrcnn.utils``
package (`utils.compute_matches` used at reference myolo/visualize.py:187,
`utils.non_max_suppression` at example/shapes/dataset_shapes.py:178) — SURVEY.md
§1 notes the new framework must provide this surface itself. This module is a
from-scratch implementation of the standard greedy VOC-style matching and AP
computation; it is also the quantitative evaluation harness the reference never
had (SURVEY.md §6: no published numbers).

All functions take pixel-space ``(x1, y1, x2, y2)`` boxes like the rest of this
framework (the matterport originals use ``(y1, x1, y2, x2)``; callers coming
from that convention should swap columns first).
"""

from __future__ import annotations

import numpy as np


def compute_overlaps(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """IoU matrix between two box sets: [N1, 4] x [N2, 4] -> [N1, N2].

    Boxes are (x1, y1, x2, y2) in pixels.
    """
    boxes1 = np.asarray(boxes1, dtype=np.float64).reshape(-1, 4)
    boxes2 = np.asarray(boxes2, dtype=np.float64).reshape(-1, 4)
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    ix1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    iy1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    ix2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    iy2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_overlaps_masks(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """IoU matrix between two mask sets: [H, W, N1] x [H, W, N2] -> [N1, N2]."""
    masks1 = np.asarray(masks1)
    masks2 = np.asarray(masks2)
    n1, n2 = masks1.shape[-1], masks2.shape[-1]
    if n1 == 0 or n2 == 0:
        return np.zeros((n1, n2))
    m1 = masks1.reshape(-1, n1).astype(np.float64)
    m2 = masks2.reshape(-1, n2).astype(np.float64)
    area1 = m1.sum(axis=0)
    area2 = m2.sum(axis=0)
    inter = m1.T @ m2
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_matches(gt_boxes, gt_class_ids, gt_masks,
                    pred_boxes, pred_class_ids, pred_scores, pred_masks=None,
                    iou_threshold: float = 0.5, score_threshold: float = 0.0):
    """Greedy score-ordered matching of predictions to ground truth.

    Same surface as the ``mrcnn.utils.compute_matches`` the reference's
    ``display_differences`` relies on (visualize.py:187), rebuilt from the
    standard definition. If ``pred_masks``/``gt_masks`` are given, IoU is
    computed on masks; otherwise on boxes.

    Returns (gt_match, pred_match, overlaps):
      gt_match:   [G] index of matching prediction, -1 if unmatched
      pred_match: [P] index of matching GT, -1 if unmatched
      overlaps:   [P, G] IoU matrix (score-sorted prediction order)
    """
    gt_boxes = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
    pred_boxes = np.asarray(pred_boxes, dtype=np.float64).reshape(-1, 4)
    gt_class_ids = np.asarray(gt_class_ids).reshape(-1)
    pred_class_ids = np.asarray(pred_class_ids).reshape(-1)
    pred_scores = np.asarray(pred_scores, dtype=np.float64).reshape(-1)

    keep = pred_scores >= score_threshold
    pred_boxes, pred_class_ids, pred_scores = (
        pred_boxes[keep], pred_class_ids[keep], pred_scores[keep])
    if pred_masks is not None:
        pred_masks = np.asarray(pred_masks)[..., keep]

    order = np.argsort(-pred_scores, kind="stable")
    pred_boxes, pred_class_ids, pred_scores = (
        pred_boxes[order], pred_class_ids[order], pred_scores[order])
    if pred_masks is not None:
        pred_masks = pred_masks[..., order]

    if pred_masks is not None and gt_masks is not None and gt_masks.shape[-1]:
        overlaps = compute_overlaps_masks(pred_masks, gt_masks)
    else:
        overlaps = compute_overlaps(pred_boxes, gt_boxes)

    gt_match, pred_match = _greedy_match(
        overlaps, gt_class_ids, pred_class_ids, iou_threshold)
    return gt_match, pred_match, overlaps


def _greedy_match(overlaps, gt_class_ids, pred_class_ids, iou_threshold):
    """Greedy match on a precomputed [P, G] IoU matrix (P score-sorted).

    Returns (gt_match [G], pred_match [P]) with -1 for unmatched.
    """
    n_pred, n_gt = overlaps.shape
    gt_match = -np.ones(n_gt, dtype=np.int64)
    pred_match = -np.ones(n_pred, dtype=np.int64)
    for p in range(n_pred):
        for g in np.argsort(-overlaps[p]):
            if gt_match[g] >= 0:
                continue
            if overlaps[p, g] < iou_threshold:
                break
            if gt_class_ids[g] == pred_class_ids[p]:
                gt_match[g] = p
                pred_match[p] = g
                break
    return gt_match, pred_match


def compute_ap(gt_boxes, gt_class_ids, gt_masks,
               pred_boxes, pred_class_ids, pred_scores, pred_masks=None,
               iou_threshold: float = 0.5):
    """Average Precision at one IoU threshold (VOC-style, all-point interp).

    Returns (mAP, precisions, recalls, overlaps) with sentinel 0/1 endpoints
    on the PR curve.
    """
    gt_match, pred_match, overlaps = compute_matches(
        gt_boxes, gt_class_ids, gt_masks,
        pred_boxes, pred_class_ids, pred_scores, pred_masks, iou_threshold)

    n_pred = len(pred_match)
    n_gt = max(len(gt_match), 1)
    tp = np.cumsum(pred_match >= 0)
    precisions = tp / (np.arange(n_pred) + 1) if n_pred else np.zeros(0)
    recalls = tp / n_gt if n_pred else np.zeros(0)

    precisions = np.concatenate([[0.0], precisions, [0.0]])
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    # monotone-decreasing envelope
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    ap = float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))
    return ap, precisions, recalls, overlaps


def compute_ap_range(gt_boxes, gt_class_ids, gt_masks,
                     pred_boxes, pred_class_ids, pred_scores, pred_masks=None,
                     iou_thresholds=None, verbose: bool = False):
    """COCO-style mean AP over IoU thresholds 0.5:0.05:0.95."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    aps = []
    for t in iou_thresholds:
        ap, _, _, _ = compute_ap(gt_boxes, gt_class_ids, gt_masks,
                                 pred_boxes, pred_class_ids, pred_scores,
                                 pred_masks, iou_threshold=float(t))
        if verbose:
            print(f"AP@{t:.2f} = {ap:.3f}")
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def _interp_ap(tp_flags: np.ndarray, n_gt: int) -> float:
    """All-point-interpolated AP from score-ordered TP flags + total GT count."""
    if n_gt == 0:
        return 0.0
    n_pred = len(tp_flags)
    if n_pred == 0:
        return 0.0
    tp = np.cumsum(tp_flags.astype(np.float64))
    precisions = tp / (np.arange(n_pred) + 1)
    recalls = tp / n_gt
    precisions = np.concatenate([[0.0], precisions, [0.0]])
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    return float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))


class APAccumulator:
    """Pools detections across a whole dataset for true VOC/COCO AP.

    Per-image AP averaging (what matterport's ``compute_ap`` invites) is NOT
    the VOC/COCO definition: detections must be pooled across the dataset,
    score-sorted globally, and the PR curve computed once per (class, IoU
    threshold). This accumulator does exactly that — ``add()`` one image at a
    time, then read ``ap(t)`` / ``map_range()``. Matching stays per-image
    (a prediction can only match GT in its own image); only the PR pooling is
    global. Macro-averaged over classes that have at least one GT instance
    (COCO convention: classes absent from GT are ignored).
    """

    def __init__(self):
        self._images = []

    def add(self, gt_boxes, gt_class_ids, gt_masks,
            pred_boxes, pred_class_ids, pred_scores, pred_masks=None):
        """Record one image's GT + predictions (masks optional, [H, W, N])."""
        gt_boxes = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
        gt_class_ids = np.asarray(gt_class_ids).reshape(-1)
        pred_boxes = np.asarray(pred_boxes, dtype=np.float64).reshape(-1, 4)
        pred_class_ids = np.asarray(pred_class_ids).reshape(-1)
        pred_scores = np.asarray(pred_scores, dtype=np.float64).reshape(-1)

        order = np.argsort(-pred_scores, kind="stable")
        pred_boxes = pred_boxes[order]
        pred_class_ids = pred_class_ids[order]
        pred_scores = pred_scores[order]

        box_overlaps = compute_overlaps(pred_boxes, gt_boxes)
        mask_overlaps = None
        if pred_masks is not None and gt_masks is not None:
            pred_masks = np.asarray(pred_masks)[..., order]
            mask_overlaps = compute_overlaps_masks(pred_masks, gt_masks)

        self._images.append({
            "gt_ids": gt_class_ids,
            "pred_ids": pred_class_ids,
            "scores": pred_scores,
            "box_overlaps": box_overlaps,
            "mask_overlaps": mask_overlaps,
        })

    def _pool(self, iou_threshold: float, use_masks: bool):
        """Match per image, pool (score, tp, class) across the dataset."""
        scores, tps, classes, gt_classes = [], [], [], []
        for im in self._images:
            overlaps = im["mask_overlaps"] if use_masks else im["box_overlaps"]
            if use_masks and overlaps is None:
                raise ValueError("mask AP requested but no masks were added")
            _, pred_match = _greedy_match(
                overlaps, im["gt_ids"], im["pred_ids"], iou_threshold)
            scores.append(im["scores"])
            tps.append(pred_match >= 0)
            classes.append(im["pred_ids"])
            gt_classes.append(im["gt_ids"])
        scores = np.concatenate(scores) if scores else np.zeros(0)
        tps = np.concatenate(tps) if tps else np.zeros(0, bool)
        classes = np.concatenate(classes) if classes else np.zeros(0, np.int64)
        gt_classes = (np.concatenate(gt_classes) if gt_classes
                      else np.zeros(0, np.int64))
        return scores, tps, classes, gt_classes

    def ap(self, iou_threshold: float = 0.5, use_masks: bool = False) -> float:
        """Pooled macro AP at one IoU threshold over classes present in GT."""
        scores, tps, classes, gt_classes = self._pool(iou_threshold, use_masks)
        class_aps = []
        for c in np.unique(gt_classes):
            sel = classes == c
            order = np.argsort(-scores[sel], kind="stable")
            class_aps.append(
                _interp_ap(tps[sel][order], int((gt_classes == c).sum())))
        return float(np.mean(class_aps)) if class_aps else 0.0

    def map_range(self, use_masks: bool = False, iou_thresholds=None) -> float:
        """Pooled COCO-style mean AP over IoU 0.5:0.05:0.95."""
        if iou_thresholds is None:
            iou_thresholds = np.arange(0.5, 1.0, 0.05)
        return float(np.mean(
            [self.ap(float(t), use_masks) for t in iou_thresholds]))


def compute_recall(pred_boxes, gt_boxes, iou: float = 0.5):
    """Fraction of GT boxes covered by any prediction at the IoU threshold.

    Returns (recall, positive_pred_ids).
    """
    overlaps = compute_overlaps(pred_boxes, gt_boxes)
    iou_max = overlaps.max(axis=0) if overlaps.size else np.zeros(0)
    recall = float((iou_max >= iou).mean()) if iou_max.size else 0.0
    positive_ids = np.where((overlaps >= iou).any(axis=1))[0]
    return recall, positive_ids
