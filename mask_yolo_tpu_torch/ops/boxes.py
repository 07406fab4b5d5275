"""Box geometry + YOLO grid decoding — port of `mask_yolo_tpu/ops/boxes.py`.

Batched tensor functions; every op runs on the input's device.
"""

from __future__ import annotations

import torch


def _cell_grid(grid_h: int, grid_w: int, like: torch.Tensor) -> torch.Tensor:
    """[grid_h, grid_w, 1, 2] (col, row) offsets — the YOLOv2 cell grid."""
    rows, cols = torch.meshgrid(
        torch.arange(grid_h, dtype=like.dtype, device=like.device),
        torch.arange(grid_w, dtype=like.dtype, device=like.device),
        indexing="ij")
    return torch.stack([cols, rows], dim=-1)[:, :, None, :]


def sigmoid(x):
    """1 / (1 + exp(-x)), written out like the JAX package's `jax_sigmoid`."""
    return 1.0 / (1.0 + torch.exp(-x))


def decode_grid(y_pred, anchors_wh, grid_h: int, grid_w: int):
    """Raw YOLO grid [..., gh, gw, nb, 5+C] → (xy, wh) in grid units:
    xy = sigmoid(txy) + cell, wh = exp(twh) · prior."""
    cell = _cell_grid(grid_h, grid_w, y_pred)
    anchors = torch.as_tensor(anchors_wh, dtype=y_pred.dtype,
                              device=y_pred.device)[None, None]
    xy = sigmoid(y_pred[..., 0:2]) + cell
    wh = torch.exp(y_pred[..., 2:4]) * anchors
    return xy, wh


def decode_yolo_proposals(y_pred, anchors_wh, grid_h: int, grid_w: int):
    """Raw grid → [B, gh·gw·nb, 4] normalized (x1, y1, x2, y2) boxes; x is
    normalized by grid_w and y by grid_h."""
    xy, wh = decode_grid(y_pred, anchors_wh, grid_h, grid_w)
    norm = torch.tensor([grid_w, grid_h], dtype=y_pred.dtype,
                        device=y_pred.device)
    xy = xy / norm
    wh = wh / norm
    boxes = torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)
    return boxes.reshape(boxes.shape[0], -1, 4)


def decode_detections(y_pred, anchors_wh, grid_h: int, grid_w: int):
    """Raw grid → [B, gh·gw·nb, 6] (x1, y1, x2, y2, score, class_id):
    score = sigmoid(conf), class_id = argmax of the class logits (first
    index on ties, as jnp.argmax)."""
    boxes = decode_yolo_proposals(y_pred, anchors_wh, grid_h, grid_w)
    b = y_pred.shape[0]
    conf = sigmoid(y_pred[..., 4]).reshape(b, -1, 1)
    cls = torch.argmax(y_pred[..., 5:], dim=-1).to(y_pred.dtype).reshape(b, -1, 1)
    return torch.cat([boxes, conf, cls], dim=-1)


def box_iou_matrix(boxes1, boxes2):
    """IoU between box sets [..., N, 4] × [..., M, 4] → [..., N, M]; boxes are
    (x1, y1, x2, y2). Zero-area pairs give NaN, which compares False."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (area1 + area2 - inter)


def norm_boxes(boxes, shape):
    """Pixel → normalized coordinates: (box - [0, 0, 1, 1]) / (dim - 1).
    boxes: [..., (x1, y1, x2, y2)] pixels; shape: (width, height)."""
    w, h = shape
    scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                         device=boxes.device) - 1.0
    shift = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32,
                         device=boxes.device)
    return (boxes - shift) / scale
