"""Loss functions — port of `mask_yolo_tpu/losses.py`.

 * `yolo_loss` — the YOLOv2 multi-part sum loss: masked MSE on (x, y) and
   (w, h) of the responsible anchors, IoU-weighted confidence MSE with a
   0.6-IoU no-object suppression against the true-box buffer, and per-cell
   softmax cross-entropy on classes. The warm-up counter `seen` is a host
   number (the trainer's step), so the warm-up branch is chosen on the host.
   twh is clipped to ±8 before exp, as in the JAX package.
 * `mask_loss` — binary cross-entropy over the positive ROIs' own class
   channel, probabilities clipped to [1e-7, 1 − 1e-7]; 0 when no ROI is
   positive.

Metrics are returned as detached tensors on the loss's device, so a training
loop reads them without waiting for the device until it logs.

Under a data group (parallel/mesh.py: each rank holds its share of the
global batch) the normalizers, `yolo_loss`'s nb_coord, nb_conf and nb_class
and `mask_loss`'s num_pos, are summed over the group before they divide, as
they are sums over the global batch in the JAX package's GSPMD step. They
carry no gradient. Each rank's loss is then its share of the global-batch
loss, and the shares add up to it. `yolo_loss`'s recall is the global
batch's too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.boxes import _cell_grid
from .parallel.collectives import all_reduce_


def _pairwise_iou_xywh(xy1, wh1, xy2, wh2):
    """IoU of center/size boxes, broadcasting. All in grid units."""
    mins1, maxs1 = xy1 - wh1 / 2.0, xy1 + wh1 / 2.0
    mins2, maxs2 = xy2 - wh2 / 2.0, xy2 + wh2 / 2.0
    iwh = torch.clamp(torch.minimum(maxs1, maxs2) - torch.maximum(mins1, mins2), min=0.0)
    inter = iwh[..., 0] * iwh[..., 1]
    a1 = wh1[..., 0] * wh1[..., 1]
    a2 = wh2[..., 0] * wh2[..., 1]
    return inter / (a1 + a2 - inter)


def yolo_loss(y_true, y_pred, true_boxes, config, seen=1e9, group=None):
    """YOLOv2 composite loss.

    y_true, y_pred: [B, gh, gw, nb, 5+C] (targets in grid-unit xywh, conf,
    one-hot; the raw network output). true_boxes: [B, 1, 1, 1, T, 4] GT boxes
    in grid units (cx, cy, w, h). seen: batches seen (a host number); below
    WARM_UP_BATCHES the warm-up targets apply. group: the data group whose
    global batch the normalizers count (None: this batch). Returns (loss,
    metrics).
    """
    dt, dev = y_pred.dtype, y_pred.device
    anchors = torch.as_tensor(config.anchors_wh, dtype=dt, device=dev)[None, None, None]
    cell_grid = _cell_grid(config.GRID_H, config.GRID_W, y_pred)[None]   # [1, gh, gw, 1, 2]

    pred_xy = torch.sigmoid(y_pred[..., 0:2]) + cell_grid
    pred_wh = torch.exp(torch.clamp(y_pred[..., 2:4], -8.0, 8.0)) * anchors
    pred_conf = torch.sigmoid(y_pred[..., 4])
    pred_class = y_pred[..., 5:]

    true_xy = y_true[..., 0:2]
    true_wh = y_true[..., 2:4]
    obj = y_true[..., 4]
    true_conf = _pairwise_iou_xywh(true_xy, true_wh, pred_xy, pred_wh) * obj
    true_class = torch.argmax(y_true[..., 5:], dim=-1)

    coord_mask = y_true[..., 4:5] * config.COORD_SCALE
    best_ious = _pairwise_iou_xywh(pred_xy[..., None, :], pred_wh[..., None, :],
                                   true_boxes[..., 0:2], true_boxes[..., 2:4]).amax(dim=-1)
    conf_mask = ((best_ious < 0.6).to(dt) * (1.0 - obj) * config.NO_OBJECT_SCALE
                 + obj * config.OBJECT_SCALE)
    class_weights = torch.as_tensor(config.class_weights, dtype=dt, device=dev)
    class_mask = obj * class_weights[true_class] * config.CLASS_SCALE

    if float(seen) < float(config.WARM_UP_BATCHES):
        no_boxes_mask = (coord_mask < config.COORD_SCALE / 2.0).to(dt)
        true_xy = true_xy + (0.5 + cell_grid) * no_boxes_mask
        true_wh = true_wh + anchors * no_boxes_mask
        coord_mask = torch.ones_like(coord_mask)

    nb_pred_box = torch.sum((true_conf > 0.5).to(dt) * (pred_conf > 0.3).to(dt)).detach()
    counts = torch.stack([(coord_mask > 0.0).to(dt).sum(), (conf_mask > 0.0).to(dt).sum(),
                          (class_mask > 0.0).to(dt).sum(), nb_pred_box, obj.sum().detach()])
    nb_coord, nb_conf, nb_class, nb_pred_box, nb_obj = all_reduce_(counts, group)

    loss_xy = torch.sum(torch.square(true_xy - pred_xy) * coord_mask) / (nb_coord + 1e-6) / 2.0
    loss_wh = torch.sum(torch.square(true_wh - pred_wh) * coord_mask) / (nb_coord + 1e-6) / 2.0
    loss_conf = torch.sum(torch.square(true_conf - pred_conf) * conf_mask) / (nb_conf + 1e-6) / 2.0
    ce = -torch.gather(F.log_softmax(pred_class, dim=-1), -1, true_class[..., None])[..., 0]
    loss_class = torch.sum(ce * class_mask) / (nb_class + 1e-6)
    loss = loss_xy + loss_wh + loss_conf + loss_class

    metrics = {"loss_xy": loss_xy, "loss_wh": loss_wh, "loss_conf": loss_conf,
               "loss_class": loss_class, "yolo_sum_loss": loss,
               "recall": nb_pred_box / (nb_obj + 1e-6)}
    return loss, {k: v.detach() for k, v in metrics.items()}


def mask_loss(target_masks, target_class_ids, pred_masks, group=None):
    """Mask-head binary cross-entropy.

    target_masks: [B, R, mh, mw] 0/1, zero-padded; target_class_ids: [B, R]
    int, 0 for negatives; pred_masks: [B, R, mh, mw, C] sigmoid
    probabilities. The mean over the positive ROIs' pixels of their class
    channel; 0 if no ROI is positive. group: the data group whose global
    batch num_pos counts (None: this batch).
    """
    mh, mw = pred_masks.shape[2:4]
    dt = pred_masks.dtype
    positive = (target_class_ids > 0).to(dt)
    ids = target_class_ids.long()[:, :, None, None, None].expand(pred_masks.shape[:-1] + (1,))
    y_pred = torch.clamp(torch.gather(pred_masks, -1, ids)[..., 0], 1e-7, 1.0 - 1e-7)
    y_true = target_masks.to(dt)
    bce = -(y_true * torch.log(y_pred) + (1.0 - y_true) * torch.log(1.0 - y_pred))
    num_pos = all_reduce_(positive.sum().detach(), group)
    total = torch.sum(bce * positive[..., None, None])
    return torch.where(num_pos > 0, total / torch.clamp(num_pos * mh * mw, min=1.0),
                       torch.zeros((), dtype=dt, device=pred_masks.device))
