"""Non-max suppression — port of `mask_yolo_tpu/ops/nms.py` (the part the
detect path runs). The greedy per-class NMS of `infer_yolo` comes with that
slice.
"""

from __future__ import annotations

import torch

from .boxes import box_iou_matrix


def index_order_class_nms_mask(boxes, class_ids, valid, iou_threshold: float):
    """The reference's second-stage class-aware NMS in *index* order: box i
    suppresses every later box j of the same class with IoU >= threshold,
    whether or not i itself was suppressed (the reference never checks), so
    the pass is one dense reduction with no sequential loop.

    boxes: [..., N, 4] normalized; class_ids: [..., N] int; valid: [..., N]
    bool (invalid slots neither suppress nor survive). Returns the keep mask.
    """
    n = boxes.shape[-2]
    idx = torch.arange(n, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    same_class = class_ids[..., :, None] == class_ids[..., None, :]
    suppressed_by = (valid[..., :, None] & later & same_class
                     & (box_iou_matrix(boxes, boxes) >= iou_threshold))
    return valid & ~suppressed_by.any(dim=-2)
