"""Mask-branch training targets, fixed shape — port of
`mask_yolo_tpu/ops/target_assign.py`.

For every proposal (TRAIN_ROIS_PER_IMAGE of them, in their original order):

 * positive iff its best IoU against the image's valid GT boxes is >= 0.5;
 * a positive takes the class id and mask of that best GT (argmax ties go to
   the first GT, as jnp.argmax);
 * the GT mask is cropped to the proposal box, resized to MASK_SHAPE with
   bilinear sampling (`roi_align.crop_and_resize_per_roi`, f32) and rounded
   to {0, 1} (round half to even, as jnp.round);
 * negatives get class 0 and a zero mask.

With mini-masks (USE_MINI_MASK) the GT masks span only their GT box, so the
proposal is first moved into its matched GT box's frame.

The JAX package vmaps a single-image function; here the batch axis is part
of every tensor op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes import box_iou_matrix
from .roi_align import crop_and_resize_per_roi


def assign_mask_targets(proposals, gt_class_ids, gt_boxes, gt_masks, mask_shape,
                        mini: bool = False):
    """proposals [B, R, 4] normalized (x1, y1, x2, y2); gt_class_ids [B, G]
    int, zero-padded; gt_boxes [B, G, 4] normalized, zero-padded; gt_masks
    [B, H, W, G] (full-size, or mini-masks of MINI_MASK_SHAPE when `mini`).
    Returns (rois [B, R, 4], target_class_ids [B, R] int32, target_masks
    [B, R, mh, mw] float32)."""
    b, r = proposals.shape[:2]
    g = gt_boxes.shape[1]
    mh, mw = mask_shape

    valid_gt = gt_boxes.abs().sum(dim=-1) > 0                       # [B, G]
    overlaps = box_iou_matrix(proposals, gt_boxes)                  # [B, R, G]
    overlaps = torch.where(valid_gt[:, None, :], overlaps, -1.0)
    positive = overlaps.max(dim=-1).values >= 0.5                   # [B, R]
    best_gt = torch.argmax(overlaps, dim=-1)                        # [B, R]

    target_class = torch.where(positive, torch.gather(gt_class_ids, 1, best_gt),
                               0).to(torch.int32)

    # each positive's GT mask, as a one-hot product (exact for 0/1 masks)
    onehot = F.one_hot(best_gt, g).float() * positive[..., None]    # [B, R, G]
    h, w = gt_masks.shape[1:3]
    masks_flat = gt_masks.float().reshape(b, h * w, g).transpose(1, 2)   # [B, G, H·W]
    roi_masks = torch.bmm(onehot, masks_flat).reshape(b * r, h, w)

    crop_boxes = proposals
    if mini:
        # ROI coordinates → the matched GT box's frame
        roi_gt_box = torch.bmm(onehot, gt_boxes.float())            # [B, R, 4]
        gw = torch.clamp(roi_gt_box[..., 2] - roi_gt_box[..., 0], min=1e-8)
        gh = torch.clamp(roi_gt_box[..., 3] - roi_gt_box[..., 1], min=1e-8)
        crop_boxes = torch.stack([
            (proposals[..., 0] - roi_gt_box[..., 0]) / gw,
            (proposals[..., 1] - roi_gt_box[..., 1]) / gh,
            (proposals[..., 2] - roi_gt_box[..., 0]) / gw,
            (proposals[..., 3] - roi_gt_box[..., 1]) / gh,
        ], dim=-1)
    cropped = crop_and_resize_per_roi(roi_masks, crop_boxes.reshape(b * r, 4), (mh, mw))
    target_masks = torch.round(cropped).reshape(b, r, mh, mw) * positive[..., None, None]
    return proposals, target_class, target_masks
