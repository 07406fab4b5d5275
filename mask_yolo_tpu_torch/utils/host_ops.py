"""Host-side (numpy) reference implementations — a copy of
`mask_yolo_tpu/utils/host_ops.py` (numpy only).

Two roles:
 1. API parity for host-format helpers (`unmold_mask`, `decode_one_yolo_output`,
    `NMB`) that the reference exposes in myolo_utils.py — users of the
    reference can keep calling these;
 2. Golden oracles for the test suite: the device pipelines in ops/ and
    pipelines.py are asserted against these straightforward ports
    (reference myolo/myolo_utils.py:21-113, 883-912).
"""

from __future__ import annotations

import numpy as np

from .image import resize_bilinear


class BoundBox(dict):
    """API-parity box object for infer_yolo results (reference
    myolo_utils.py:161-185): attribute access (`box.xmin`), the reference's
    `get_label()`/`get_score()` methods, AND dict access (`box["xmin"]`) —
    so both migrating reference code and this framework's existing
    dict-consuming code (visualize.draw_boxes_mpl, tests) work unchanged.

    Construct either reference-style with `classes=` (a per-class score
    vector; label/score are derived by argmax like the reference's lazy
    getters) or directly with `score=`/`label=` (the device pipeline already
    resolved the winning class on-chip)."""

    def __init__(self, xmin, ymin, xmax, ymax, c=None, classes=None,
                 score=None, label=None):
        if classes is not None:
            classes = np.asarray(classes)
            if label is None:
                label = int(np.argmax(classes))
            if score is None:
                score = float(classes[label])
        super().__init__(
            xmin=float(xmin), ymin=float(ymin),
            xmax=float(xmax), ymax=float(ymax),
            score=float(score) if score is not None else 0.0,
            label=int(label) if label is not None else -1)
        if c is not None:
            self["c"] = float(c)
        if classes is not None:
            self["classes"] = classes

    xmin = property(lambda self: self["xmin"])
    ymin = property(lambda self: self["ymin"])
    xmax = property(lambda self: self["xmax"])
    ymax = property(lambda self: self["ymax"])
    c = property(lambda self: self.get("c", self["score"]))
    classes = property(lambda self: self.get("classes"))
    score = property(lambda self: self["score"])
    label = property(lambda self: self["label"])

    def get_label(self):
        return self["label"]

    def get_score(self):
        return self["score"]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x, axis=-1, t=-100.0):
    """The reference's softmax quirk (myolo_utils.py:25-33): global max shift
    plus a rescale when the minimum is very negative."""
    x = x - np.max(x)
    if np.min(x) < t:
        x = x / np.min(x) * t
    e_x = np.exp(x)
    return e_x / e_x.sum(axis, keepdims=True)


def bbox_iou_xyxy(a, b):
    """IoU of two (x1, y1, x2, y2) boxes (myolo_utils.py:187-198)."""
    iw = min(a[2], b[2]) - max(a[0], b[0])
    ih = min(a[3], b[3]) - max(a[1], b[1])
    inter = max(iw, 0.0) * max(ih, 0.0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter) / ua if ua > 0 else 0.0


def decode_one_yolo_output(netout, anchors, nb_class, obj_threshold=0.3,
                           nms_threshold=0.3):
    """Numpy port of the reference host decoder (myolo_utils.py:36-85).

    netout: [gh, gw, nb, 5+C] raw grid (modified in place like the reference).
    Returns a list of BoundBox (dict-compatible: {xmin, ymin, xmax, ymax,
    score, label, classes}; reference-compatible: .xmin/.get_label()/...).
    """
    grid_h, grid_w, nb_box = netout.shape[:3]
    netout = np.array(netout, dtype=np.float64)
    netout[..., 4] = _sigmoid(netout[..., 4])
    netout[..., 5:] = netout[..., 4][..., np.newaxis] * _softmax(netout[..., 5:])
    netout[..., 5:] *= netout[..., 5:] > obj_threshold

    boxes = []
    for row in range(grid_h):
        for col in range(grid_w):
            for b in range(nb_box):
                classes = netout[row, col, b, 5:]
                if np.sum(classes) > 0:
                    x, y, w, h = netout[row, col, b, :4]
                    x = (col + _sigmoid(x)) / grid_w
                    y = (row + _sigmoid(y)) / grid_h
                    w = anchors[2 * b + 0] * np.exp(w) / grid_w
                    h = anchors[2 * b + 1] * np.exp(h) / grid_h
                    boxes.append(BoundBox(
                        xmin=x - w / 2, ymin=y - h / 2,
                        xmax=x + w / 2, ymax=y + h / 2,
                        c=netout[row, col, b, 4],
                        classes=classes.copy()))

    # per-class greedy NMS zeroing suppressed class scores
    for c in range(nb_class):
        sorted_indices = list(reversed(np.argsort([bx["classes"][c] for bx in boxes])))
        for i in range(len(sorted_indices)):
            index_i = sorted_indices[i]
            if boxes[index_i]["classes"][c] == 0:
                continue
            bi = boxes[index_i]
            for j in range(i + 1, len(sorted_indices)):
                index_j = sorted_indices[j]
                bj = boxes[index_j]
                iou = bbox_iou_xyxy(
                    (bi["xmin"], bi["ymin"], bi["xmax"], bi["ymax"]),
                    (bj["xmin"], bj["ymin"], bj["xmax"], bj["ymax"]))
                if iou >= nms_threshold:
                    boxes[index_j]["classes"][c] = 0

    out = []
    for bx in boxes:
        label = int(np.argmax(bx["classes"]))
        score = float(bx["classes"][label])
        if score > obj_threshold:
            bx["label"] = label
            bx["score"] = score
            out.append(bx)
    return out


def NMB(boxes, class_ids, indices, image_shape, nms_threshold=0.3):
    """Second-stage class-aware suppression (myolo_utils.py:88-113): iterate
    in index order; i suppresses every later j with same class and
    pixel-space IoU >= threshold. Returns surviving entries of `indices`."""
    h, w = image_shape[0], image_shape[1]  # image_shape is [H, W, ...]
    scale = np.array([w, h, w, h], dtype=np.float64)
    list_to_remove = []
    for i in range(len(indices)):
        for j in range(i + 1, len(indices)):
            if j in list_to_remove:
                continue
            if (bbox_iou_xyxy(boxes[i] * scale, boxes[j] * scale) >= nms_threshold
                    and class_ids[i] == class_ids[j]):
                list_to_remove.append(j)
    return np.delete(np.asarray(indices), sorted(set(list_to_remove)))


def unmold_mask(mask, bbox, image_shape, threshold=0.5):
    """28x28 float mask → full-image boolean mask (myolo_utils.py:883-912).

    bbox: (x1, y1, x2, y2) normalized.
    """
    h, w = image_shape[0], image_shape[1]  # image_shape is [H, W, ...]
    x1, y1, x2, y2 = bbox
    x1 = min(max(0, int(x1 * w)), w)
    x2 = min(max(1, int(x2 * w)), w)
    y1 = min(max(0, int(y1 * h)), h)
    y2 = min(max(1, int(y2 * h)), h)
    m = resize_bilinear(mask, (max(1, y2 - y1), max(1, x2 - x1)))
    m = (m >= threshold)
    full_mask = np.zeros(tuple(image_shape[:2]), dtype=bool)
    full_mask[y1:y2, x1:x2] = m
    return full_mask


def crop_and_resize_np(image, boxes, crop_size, extrapolation_value=0.0):
    """Numpy port of tf.image.crop_and_resize (bilinear) — the golden oracle
    for ops/roi_align.py. image: [H, W] or [H, W, C]; boxes: [N, 4]
    (y1, x1, y2, x2) normalized, TF argument order."""
    image = np.asarray(image, dtype=np.float64)
    squeeze = image.ndim == 2
    if squeeze:
        image = image[:, :, None]
    h, w, c = image.shape
    ch, cw = crop_size
    out = np.full((len(boxes), ch, cw, c), extrapolation_value, dtype=np.float64)
    for n, (y1, x1, y2, x2) in enumerate(boxes):
        if ch > 1:
            ys = y1 * (h - 1) + np.arange(ch) * (y2 - y1) * (h - 1) / (ch - 1)
        else:
            ys = np.full(ch, 0.5 * (y1 + y2) * (h - 1))
        if cw > 1:
            xs = x1 * (w - 1) + np.arange(cw) * (x2 - x1) * (w - 1) / (cw - 1)
        else:
            xs = np.full(cw, 0.5 * (x1 + x2) * (w - 1))
        for i, yy in enumerate(ys):
            if yy < 0 or yy > h - 1:
                continue
            y0 = int(np.floor(yy))
            y1i = min(y0 + 1, h - 1)
            fy = yy - y0
            for j, xx in enumerate(xs):
                if xx < 0 or xx > w - 1:
                    continue
                x0 = int(np.floor(xx))
                x1i = min(x0 + 1, w - 1)
                fx = xx - x0
                top = image[y0, x0] * (1 - fx) + image[y0, x1i] * fx
                bot = image[y1i, x0] * (1 - fx) + image[y1i, x1i] * fx
                out[n, i, j] = top * (1 - fy) + bot * fy
    return out[..., 0] if squeeze else out
