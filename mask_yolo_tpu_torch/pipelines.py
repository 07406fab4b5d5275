"""The training forward and the detect path — port of
`mask_yolo_tpu/pipelines.py` (`training_loss`, `yolo_only_loss`,
`images_f32`, `infer_yolo_outputs`, `infer_yolo_from_callables`,
`detect_outputs`, `detect_from_callables`).

`training_loss` runs the trunk, decodes the proposals (no gradient flows
into them), assigns mask targets, keeps the MASK_TRAIN_TOP_ROIS best
assignment slots (positives first), runs the mask branch on them through the
crop kernel, and sums the YOLO and mask losses with LOSS_WEIGHTS.
`yolo_only_loss` is the trunk and the YOLO loss alone. Both set the
network's BatchNorm mode: batch statistics iff `train` and TRAIN_BN.

Decode, zero-area filter, score top-K, index-order class NMS, the MASK_TOP_K
valid-first re-sort, the mask branch on the surviving slots, the paste to
the image canvas and the 0.5 threshold all run on the input's device, in
fixed shapes, with no host round trip.

`infer_yolo_outputs` is detection alone: decode, the conf-weighted class
probabilities through the reference's softmax, the per-class greedy NMS
(`ops/nms.py`, one chain for the whole batch) and each box's winning class.

`lax.top_k` returns ties in index order; the port sorts with a stable
descending sort to keep that order.
"""

from __future__ import annotations

import torch

from .losses import mask_loss, yolo_loss
from .ops.boxes import decode_detections, decode_yolo_proposals, norm_boxes
from .ops.nms import (class_aware_nms, first_argmax, index_order_class_nms_mask,
                      per_class_topk_nms, reference_softmax)
from .ops.nms import stable_top_k as _top_k
from .ops.roi_align import paste_masks
from .ops.target_assign import assign_mask_targets


def images_f32(images):
    """uint8 images → float32 in [0, 1] on their device; float images pass
    through unchanged."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def _take(x, idx):
    """x[b, idx[b, j], ...] for x [B, N, ...] and idx [B, k]."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def training_loss(net, batch, config, seen, train: bool = True):
    """The 'training'-mode forward and combined loss.

    batch: dict of tensors on the network's device —
      image [B, H, W, 3] uint8 or float in [0, 1], yolo_target
      [B, gh, gw, nb, 5+C], true_boxes [B, 1, 1, 1, T, 4], gt_class_ids
      [B, G] int, gt_boxes [B, G, 4] pixel xyxy, gt_masks [B, h, w, G] bool.
    seen: batches seen (host number), for the YOLO loss's warm-up.
    Returns (loss, metrics) with metrics detached.
    """
    net.train(train and bool(config.TRAIN_BN))
    grid, fmap = net.trunk(images_f32(batch["image"]))

    h, w = config.IMAGE_SHAPE[:2]
    proposals = decode_yolo_proposals(grid, config.anchors_wh, config.GRID_H,
                                      config.GRID_W).detach()
    gt_boxes_norm = norm_boxes(batch["gt_boxes"], (w, h))
    rois, target_class_ids, target_masks = assign_mask_targets(
        proposals, batch["gt_class_ids"], gt_boxes_norm, batch["gt_masks"].float(),
        tuple(config.MASK_SHAPE), bool(config.USE_MINI_MASK))

    # MASK_TRAIN_TOP_ROIS: the mask branch on the top-M assignment slots,
    # positives first in index order (lax.top_k's ties)
    m_top = int(getattr(config, "MASK_TRAIN_TOP_ROIS", 0) or 0)
    if m_top and m_top < rois.shape[1]:
        _, order = _top_k((target_class_ids > 0).float(), m_top)
        rois = _take(rois, order)
        target_class_ids = _take(target_class_ids, order)
        target_masks = _take(target_masks, order)

    pred_masks = net.mask_branch(rois, fmap)
    y_loss, metrics = yolo_loss(batch["yolo_target"], grid, batch["true_boxes"],
                                config, seen)
    m_loss = mask_loss(target_masks, target_class_ids, pred_masks)
    lw = config.LOSS_WEIGHTS
    total = (y_loss * lw.get("yolo_sum_loss", 1.0)
             + m_loss * lw.get("myolo_mask_loss", 1.0))
    metrics["myolo_mask_loss"] = m_loss.detach()
    metrics["loss"] = total.detach()
    return total, metrics


def yolo_only_loss(net, batch, config, seen, train: bool = True):
    """The 'yolo'-mode forward: trunk and YOLO loss only. batch needs image,
    yolo_target and true_boxes. Returns (loss, metrics)."""
    net.train(train and bool(config.TRAIN_BN))
    grid, _ = net.trunk(images_f32(batch["image"]))
    loss, metrics = yolo_loss(batch["yolo_target"], grid, batch["true_boxes"],
                              config, seen)
    metrics["loss"] = loss.detach()
    return loss, metrics


def infer_yolo_outputs(net, images, config):
    """Detection-only inference with a `MaskYoloNet`.

    images: [B, H, W, 3] uint8 or float in [0, 1]. Returns per image
    (N = GRID_H·GRID_W·N_BOX):
      boxes   [B, N, 4] float32 normalized xyxy
      scores  [B, N] float32, the winning class score after per-class NMS
      classes [B, N] int32, the winning class
      valid   [B, N] bool (score > OBJ_THRESHOLD)
    """
    return infer_yolo_from_callables(net.trunk, images, config)


def infer_yolo_from_callables(trunk, images, config):
    """infer_yolo_outputs with a pluggable trunk executor (images → (grid,
    fmap)), shared by the float path and the int8 path
    (quant.QuantizedDetector.infer_yolo_fn).

    INFER_YOLO_PER_CLASS_K compacts each class to its own top-K boxes before
    the greedy chain; INFER_YOLO_TOP_N runs the NMS on the N boxes with the
    highest max-class probability; the per-class K takes precedence. Both
    give the full-grid result while no more boxes pass OBJ_THRESHOLD than
    they keep (boxes below it carry all-zero probabilities, which neither
    suppress nor survive)."""
    grid, _ = trunk(images_f32(images))
    grid = grid.float()
    boxes = decode_yolo_proposals(grid, config.anchors_wh, config.GRID_H, config.GRID_W)
    b, c = grid.shape[0], config.NUM_CLASSES
    conf = torch.sigmoid(grid[..., 4])   # jax.nn.sigmoid there
    n_top = int(getattr(config, "INFER_YOLO_TOP_N", 0) or 0)
    k_cls = int(getattr(config, "INFER_YOLO_PER_CLASS_K", 0) or 0)

    # conf-weighted class probabilities, thresholded; the softmax's shift is
    # by each image's own maximum
    probs = conf[..., None] * reference_softmax(grid[..., 5:], batch_dims=1)
    probs = (probs * (probs > config.OBJ_THRESHOLD)).reshape(b, -1, c)
    n = probs.shape[1]
    if k_cls and k_cls < n:
        probs = per_class_topk_nms(boxes, probs, k_cls, config.NMS_THRESHOLD)
    elif n_top and n_top < n:
        _, idx = _top_k(probs.amax(dim=-1), n_top)
        kept = class_aware_nms(_take(boxes, idx), _take(probs, idx), config.NMS_THRESHOLD)
        probs = torch.zeros_like(probs).scatter_(
            1, idx[..., None].expand(b, n_top, c), kept)
    else:
        probs = class_aware_nms(boxes, probs, config.NMS_THRESHOLD)
    scores, classes = first_argmax(probs)
    return {"boxes": boxes, "scores": scores, "classes": classes.to(torch.int32),
            "valid": scores > config.OBJ_THRESHOLD}


def detect_outputs(net, images, config):
    """Full image → boxes + instance masks with a `MaskYoloNet`.

    images: [B, H, W, 3] uint8 or float in [0, 1]. Returns per image
    (K = DETECTION_MAX_INSTANCES):
      boxes   [B, K, 4] float32 pixel xyxy
      classes [B, K] int32
      scores  [B, K] float32
      masks   [B, K, H, W] bool full-size instance masks
      valid   [B, K] bool
    """
    return detect_from_callables(net.trunk, net.mask_branch, images, config)


def detect_from_callables(trunk, mask_branch, images, config,
                          score_threshold=None, fused_mask=None):
    """detect_outputs with pluggable trunk (images → (grid, fmap)) and mask
    branch ((rois, fmap) → [B, k, mh, mw, C] sigmoid masks) executors, shared
    by the float path and the int8 path (quant.py).

    score_threshold: a detection is valid above it (default OBJ_THRESHOLD).
    fused_mask: optional (rois, fmap, classes) → [B, k, mh, mw] sigmoid masks
    already selected by each ROI's class (the fused mask kernel,
    ops/mask_fused.py); when given it replaces mask_branch and the class
    select."""
    if score_threshold is None:
        score_threshold = config.OBJ_THRESHOLD
    k = config.DETECTION_MAX_INSTANCES
    h, w = config.IMAGE_SHAPE[:2]

    grid, fmap = trunk(images_f32(images))
    det = decode_detections(grid.float(), config.anchors_wh, config.GRID_H,
                            config.GRID_W)
    boxes, scores, classes = det[..., :4], det[..., 4], det[..., 5].to(torch.int32)

    # zero-area filter folded into validity
    area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0

    # top-K by score; zero-area boxes sort last
    top_scores, idx = _top_k(torch.where(area_ok, scores, -1.0), k)
    top_boxes = _take(boxes, idx)
    top_classes = _take(classes, idx)
    valid = top_scores > score_threshold

    # the reference's second-stage class-aware NMS, in index (= score) order
    det_nms = float(getattr(config, "DETECTION_NMS_THRESHOLD", 0.7))
    valid = valid & index_order_class_nms_mask(top_boxes, top_classes, valid,
                                               det_nms)

    # MASK_TOP_K: masks for only the kp best NMS survivors. Slots are
    # re-sorted valid-first (score order kept within each group), so the
    # survivors lead; identical detections while <= kp boxes survive.
    kp = int(getattr(config, "MASK_TOP_K", 0) or 0)
    kp = min(kp, k) if kp > 0 else k
    if kp < k:
        _, order = _top_k(torch.where(valid, top_scores + 2.0, top_scores), k)
        top_boxes = _take(top_boxes, order)
        top_scores = _take(top_scores, order)
        top_classes = _take(top_classes, order)
        valid = _take(valid, order)
    mask_boxes = top_boxes[:, :kp].contiguous()
    mask_classes = top_classes[:, :kp]

    # mask branch on the kp survivors only, then each ROI's own class
    if fused_mask is not None:
        sel_masks = fused_mask(mask_boxes, fmap, mask_classes)  # [B, kp, mh, mw]
    else:
        pred_masks = mask_branch(mask_boxes, fmap)             # [B, kp, mh, mw, C]
        sel = mask_classes.long()[:, :, None, None, None].expand(
            pred_masks.shape[:-1] + (1,))
        sel_masks = torch.gather(pred_masks, -1, sel)[..., 0]  # [B, kp, mh, mw]

    # paste onto the image canvas and threshold at 0.5; bf16 configs paste
    # in bf16 (ops/roi_align.paste_masks)
    paste_dtype = (torch.bfloat16 if config.COMPUTE_DTYPE == "bfloat16"
                   else torch.float32)
    full = paste_masks(sel_masks, mask_boxes, (h, w), dtype=paste_dtype)
    full_bool = (full >= 0.5) & valid[:, :kp, None, None]
    if kp < k:  # slots beyond kp carry no mask
        full_bool = torch.cat([full_bool, full_bool.new_zeros(
            (full_bool.shape[0], k - kp, h, w))], dim=1)

    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=top_boxes.device)
    return {
        "boxes": top_boxes * scale,
        "classes": top_classes,
        "scores": top_scores,
        "masks": full_bool,
        "valid": valid,
    }
