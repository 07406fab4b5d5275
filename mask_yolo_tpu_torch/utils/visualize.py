"""Visualization (matplotlib-only) — a copy of `mask_yolo_tpu/utils/visualize.py`;
matplotlib is imported inside the functions that draw.

Parity port of the reference's visualize module
(reference myolo/visualize.py): display_instances, draw_boxes,
display_top_masks, plot_precision_recall, plot_overlaps,
display_weight_stats — reimplemented without skimage/cv2 (mask outlines are
drawn from an erosion-based edge map instead of skimage.find_contours).
"""

from __future__ import annotations

import colorsys
import random as _random

import numpy as np


def random_colors(n, bright=True, seed=None):
    """N visually distinct colors (reference visualize.py:40-50)."""
    brightness = 1.0 if bright else 0.7
    hsv = [(i / n, 1, brightness) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    rng = _random.Random(seed)
    rng.shuffle(colors)
    return colors


def apply_mask(image, mask, color, alpha=0.5):
    """Blend a boolean mask into an image (reference visualize.py:53-61)."""
    image = image.astype(np.float32).copy()
    for c in range(3):
        image[:, :, c] = np.where(
            mask, image[:, :, c] * (1 - alpha) + alpha * color[c] * 255,
            image[:, :, c])
    return image.astype(np.uint8)


def _mask_edges(mask):
    """Boolean edge map: mask minus its 4-neighbour erosion."""
    m = mask.astype(bool)
    er = m.copy()
    er[1:, :] &= m[:-1, :]
    er[:-1, :] &= m[1:, :]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def display_instances(image, boxes, masks, class_ids, class_names, scores=None,
                      save_path=None, title="", figsize=(8, 8), ax=None,
                      show=False):
    """Boxes + translucent masks + outlines + captions (reference
    visualize.py:83-176). boxes: [N, (x1, y1, x2, y2)] pixels;
    masks: [H, W, N]; class_ids: [N]."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    n = len(boxes)
    colors = random_colors(max(n, 1), seed=0)
    created = ax is None
    if created:
        fig, ax = plt.subplots(1, figsize=figsize)

    h, w = image.shape[:2]
    ax.set_ylim(h + 10, -10)
    ax.set_xlim(-10, w + 10)
    ax.axis("off")
    ax.set_title(title)

    masked_image = image.astype(np.uint8).copy()
    for i in range(n):
        color = colors[i % len(colors)]
        if masks is not None and masks.shape[-1] > i:
            masked_image = apply_mask(masked_image, masks[:, :, i], color)

    ax.imshow(masked_image)
    for i in range(n):
        color = colors[i % len(colors)]
        x1, y1, x2, y2 = boxes[i]
        ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2,
                               alpha=0.7, edgecolor=color, facecolor="none"))
        class_id = int(class_ids[i])
        score = scores[i] if scores is not None else None
        label = class_names[class_id] if class_id < len(class_names) else str(class_id)
        caption = f"{label} {score:.3f}" if score is not None else label
        ax.text(x1, y1 + 8, caption, color="w", size=11,
                backgroundcolor="none")
        if masks is not None and masks.shape[-1] > i:
            ys, xs = np.where(_mask_edges(masks[:, :, i]))
            ax.scatter(xs, ys, s=0.5, c=[color])

    if save_path:
        import matplotlib
        plt.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    if created and not show:
        plt.close(ax.figure)
    return ax


def draw_boxes_mpl(image, boxes, labels, save_file=None, show=False):
    """Detection-box overlay used by infer_yolo (reference's cv2 draw_boxes,
    myolo_utils.py:863-880). boxes: list of dicts with normalized
    xmin/ymin/xmax/ymax + score + label."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    h, w = image.shape[:2]
    fig, ax = plt.subplots(1, figsize=(8, 8))
    ax.imshow(image)
    ax.axis("off")
    for box in boxes:
        x1, y1 = box["xmin"] * w, box["ymin"] * h
        x2, y2 = box["xmax"] * w, box["ymax"] * h
        ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2,
                               edgecolor="lime", facecolor="none"))
        name = labels[box["label"]] if box["label"] < len(labels) else str(box["label"])
        ax.text(x1, max(y2 - 13, 0), f"{name} {box['score']:.2f}",
                color="lime", size=10)
    if save_file:
        plt.savefig(save_file, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)


def display_differences(image, gt_boxes, gt_class_ids, gt_masks,
                        pred_boxes, pred_class_ids, pred_scores, pred_masks,
                        class_names, title="", save_path=None,
                        iou_threshold=0.5, score_threshold=0.5, show_mask=True,
                        show_box=True):
    """GT vs prediction overlay (reference visualize.py:179-214): GT drawn in
    green, predictions colored by match quality (red caption shows score/IoU).
    Boxes are pixel (x1, y1, x2, y2)."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    from .metrics import compute_matches

    gt_match, pred_match, overlaps = compute_matches(
        gt_boxes, gt_class_ids, gt_masks,
        pred_boxes, pred_class_ids, pred_scores, pred_masks,
        iou_threshold=iou_threshold, score_threshold=score_threshold)

    fig, ax = plt.subplots(1, figsize=(8, 8))
    h, w = image.shape[:2]
    ax.set_ylim(h + 10, -10)
    ax.set_xlim(-10, w + 10)
    ax.axis("off")
    ax.set_title(title or "Ground Truth (green) vs Predictions "
                          "(red = unmatched)")

    canvas = image.astype(np.uint8).copy()
    green, red = (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)
    if show_mask and gt_masks is not None:
        for i in range(gt_masks.shape[-1]):
            canvas = apply_mask(canvas, gt_masks[:, :, i], green, alpha=0.25)
    if show_mask and pred_masks is not None:
        for i in range(pred_masks.shape[-1]):
            m = pred_match[i] >= 0 if i < len(pred_match) else False
            canvas = apply_mask(canvas, pred_masks[:, :, i],
                                green if m else red, alpha=0.25)
    ax.imshow(canvas)

    if show_box:
        for i, box in enumerate(np.asarray(gt_boxes).reshape(-1, 4)):
            x1, y1, x2, y2 = box
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2,
                                   edgecolor=green, facecolor="none",
                                   linestyle="dotted"))
            cid = int(np.asarray(gt_class_ids).reshape(-1)[i])
            name = class_names[cid] if cid < len(class_names) else str(cid)
            ax.text(x1, y1 - 3, name, color="g", size=10)
        for i, box in enumerate(np.asarray(pred_boxes).reshape(-1, 4)):
            x1, y1, x2, y2 = box
            matched = i < len(pred_match) and pred_match[i] >= 0
            color = green if matched else red
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2,
                                   edgecolor=color, facecolor="none"))
            cid = int(np.asarray(pred_class_ids).reshape(-1)[i])
            score = float(np.asarray(pred_scores).reshape(-1)[i])
            iou = float(overlaps[i, pred_match[i]]) if matched else 0.0
            name = class_names[cid] if cid < len(class_names) else str(cid)
            ax.text(x1, y2 + 10, f"{name} {score:.2f} / IoU {iou:.2f}",
                    color=color, size=9)
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return gt_match, pred_match, overlaps


def draw_rois(image, rois, refined_rois=None, mask=None, class_ids=None,
              class_names=None, limit=10, save_path=None):
    """Sampled-ROI overlay for debugging target assignment (reference
    visualize.py:217-275). rois: [N, (x1, y1, x2, y2)] pixels; dotted boxes,
    solid refined boxes when given."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    rois = np.asarray(rois).reshape(-1, 4)
    n = len(rois)
    ids = np.arange(n) if n <= limit else np.random.default_rng(0).choice(
        n, limit, replace=False)

    fig, ax = plt.subplots(1, figsize=(8, 8))
    h, w = image.shape[:2]
    ax.set_ylim(h + 20, -20)
    ax.set_xlim(-20, w + 20)
    ax.axis("off")
    ax.set_title(f"Showing {len(ids)} of {n} ROIs")

    canvas = image.astype(np.uint8).copy()
    colors = random_colors(len(ids), seed=0)
    for k, i in enumerate(ids):
        if mask is not None and class_ids is not None and class_ids[i] > 0:
            canvas = apply_mask(canvas, mask[:, :, i].astype(bool), colors[k])
    ax.imshow(canvas)
    for k, i in enumerate(ids):
        color = colors[k]
        x1, y1, x2, y2 = rois[i]
        ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2,
                               edgecolor=color, facecolor="none",
                               linestyle="dashed"))
        if refined_rois is not None and class_ids is not None and class_ids[i] > 0:
            rx1, ry1, rx2, ry2 = np.asarray(refined_rois).reshape(-1, 4)[i]
            ax.add_patch(Rectangle((rx1, ry1), rx2 - rx1, ry2 - ry1,
                                   linewidth=2, edgecolor=color,
                                   facecolor="none"))
            ax.plot([x1, rx1], [y1, ry1], color=color)
        if class_ids is not None:
            cid = int(class_ids[i])
            name = (class_names[cid] if class_names is not None
                    and cid < len(class_names) else str(cid))
            ax.text(x1, y1 + 8, name if cid > 0 else "",
                    color="w", size=11, backgroundcolor="none")
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def display_top_masks(image, mask, class_ids, class_names, limit=4,
                      save_path=None):
    """Image + the `limit` largest class masks (reference visualize.py:291-311)."""
    import matplotlib.pyplot as plt

    to_show = [(image, "original")]
    unique_ids = np.unique(class_ids)
    areas = [np.sum(mask[:, :, np.where(class_ids == cid)[0]]) for cid in unique_ids]
    top_ids = [u for _, u in sorted(zip(areas, unique_ids), reverse=True)][:limit]
    for cid in top_ids:
        m = mask[:, :, np.where(class_ids == cid)[0]].any(axis=-1)
        to_show.append((m.astype(np.uint8) * 255,
                        class_names[int(cid)] if int(cid) < len(class_names) else str(cid)))
    cols = len(to_show)
    fig, axes = plt.subplots(1, cols, figsize=(4 * cols, 4))
    if cols == 1:
        axes = [axes]
    for axi, (img, name) in zip(axes, to_show):
        axi.imshow(img, cmap="gray" if img.ndim == 2 else None)
        axi.set_title(name)
        axi.axis("off")
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def plot_precision_recall(AP, precisions, recalls, save_path=None):
    """Precision-recall curve (reference visualize.py:314-326)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1)
    ax.set_title(f"Precision-Recall Curve. AP@50 = {AP:.3f}")
    ax.set_ylim(0, 1.1)
    ax.set_xlim(0, 1.1)
    ax.plot(recalls, precisions)
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def plot_overlaps(gt_class_ids, pred_class_ids, pred_scores, overlaps,
                  class_names, threshold=0.5, save_path=None):
    """Grid of prediction-vs-GT IoU overlaps (reference visualize.py:329-365)."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 10))
    plt.imshow(overlaps, interpolation="nearest", cmap=plt.cm.Blues)
    plt.yticks(
        np.arange(len(pred_class_ids)),
        [f"{class_names[int(i)]} ({s:.2f})"
         for i, s in zip(pred_class_ids, pred_scores)])
    plt.xticks(
        np.arange(len(gt_class_ids)),
        [class_names[int(i)] for i in gt_class_ids], rotation=90)
    for i in range(overlaps.shape[0]):
        for j in range(overlaps.shape[1]):
            text = ""
            if overlaps[i, j] > threshold:
                text = "match" if gt_class_ids[j] == pred_class_ids[i] else "wrong"
            plt.text(j, i, f"{overlaps[i, j]:.3f}\n{text}",
                     ha="center", va="center", fontsize=9)
    plt.xlabel("Ground Truth")
    plt.ylabel("Predictions")
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def draw_box(image, box, color, thickness=2):
    """Draw a box outline on a numpy image in place (the mrcnn utils.draw_box
    the reference's debug paths lean on; also used by the generator's
    norm=False debug mode, reference myolo_utils.py:826-840).

    box: (x1, y1, x2, y2) pixels; color: per-channel value(s)."""
    h, w = image.shape[:2]
    x1, y1, x2, y2 = (int(round(float(v))) for v in box[:4])
    x1, x2 = np.clip([x1, x2], 0, w - 1)
    y1, y2 = np.clip([y1, y2], 0, h - 1)
    t = int(thickness)
    image[y1:y1 + t, x1:x2 + 1] = color
    image[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = color
    image[y1:y2 + 1, x1:x1 + t] = color
    image[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = color
    return image


def draw_boxes(image, boxes=None, refined_boxes=None, masks=None,
               captions=None, visibilities=None, title="", ax=None,
               save_path=None, show=False):
    """The full debug overlay of the reference (visualize.py:368-468):
    anchors/proposals in dotted style, refined boxes solid with a connector
    line from the original box, per-box captions, optional masks.

    boxes / refined_boxes: [N, (x1, y1, x2, y2)] pixels (this framework's
    box convention; the reference uses (y1, x1, y2, x2)).
    visibilities: per-box 0 = gray faint, 1 = dotted, 2 = solid
    (reference visibility semantics, visualize.py:400-410).
    """
    import matplotlib.pyplot as plt
    from matplotlib import lines
    from matplotlib.patches import Rectangle

    n = 0
    if boxes is not None:
        n = max(n, len(boxes))
    if refined_boxes is not None:
        n = max(n, len(refined_boxes))

    created = ax is None
    if created:
        _, ax = plt.subplots(1, figsize=(12, 12))
    colors = random_colors(max(n, 1), seed=0)

    margin = image.shape[0] // 10
    ax.set_ylim(image.shape[0] + margin, -margin)
    ax.set_xlim(-margin, image.shape[1] + margin)
    ax.axis("off")
    ax.set_title(title)

    masked_image = image.astype(np.uint8).copy()
    for i in range(n):
        # visibility → style (reference visualize.py:400-410)
        visibility = visibilities[i] if visibilities is not None else 1
        if visibility == 0:
            color, style, alpha = "gray", "dotted", 0.5
        elif visibility == 1:
            color, style, alpha = colors[i], "dotted", 1
        else:
            color, style, alpha = colors[i], "solid", 1

        x1 = y1 = x2 = y2 = None
        if boxes is not None and i < len(boxes):
            if not np.any(boxes[i]):
                continue  # skip padded zero boxes in cropped images
            x1, y1, x2, y2 = boxes[i]
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2,
                                   alpha=alpha, linestyle=style,
                                   edgecolor=color, facecolor="none"))

        # refined boxes drawn solid, connected to the original by a line
        # (reference visualize.py:424-436)
        if refined_boxes is not None and i < len(refined_boxes) and visibility > 0:
            rx1, ry1, rx2, ry2 = np.asarray(refined_boxes[i], dtype=np.float32)
            ax.add_patch(Rectangle((rx1, ry1), rx2 - rx1, ry2 - ry1,
                                   linewidth=2, edgecolor=color,
                                   facecolor="none"))
            if x1 is not None:
                ax.add_line(lines.Line2D([x1, rx1], [y1, ry1], color=color))
            if x1 is None:
                x1, y1 = rx1, ry1

        if captions is not None and i < len(captions) and captions[i] is not None \
                and x1 is not None:
            ax.text(x1, y1, captions[i], size=11, verticalalignment="top",
                    color="w", backgroundcolor="none",
                    bbox={"facecolor": color if visibility else "gray",
                          "alpha": 0.5, "pad": 2, "edgecolor": "none"})

        if masks is not None and masks.shape[-1] > i:
            m = masks[:, :, i]
            masked_image = apply_mask(masked_image, m, colors[i])
            ys, xs = np.where(_mask_edges(m))
            ax.scatter(xs, ys, s=0.5, c=[colors[i]])

    ax.imshow(masked_image)
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    elif created:
        plt.close(ax.figure)
    return ax


def _named_leaves(tree, prefix=""):
    """(slash-joined name, leaf) of a nested dict, keys in sorted order."""
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(value, "items"):
            yield from _named_leaves(value, name)
        else:
            yield name, value


def display_weight_stats(params):
    """Table of per-parameter stats with dead/overflow flags (reference
    visualize.py:485-510). params: the network's `state_dict()` (tensors or
    numpy arrays by dotted key), or a nested dict of arrays such as the
    flax-layout tree `weights.to_jax_variables` gives, whose rows come in the
    JAX package's order. Returns list of rows."""
    rows = [("name", "shape", "min", "max", "std", "flags")]
    for name, w in _named_leaves(params):
        w = np.asarray(w.detach().float().cpu() if hasattr(w, "detach") else w)
        if w.size == 0 or w.ndim == 0:
            continue
        alert = []
        if w.min() == w.max() and w.ndim > 1:
            alert.append("*** dead?")
        if np.abs(w.min()) > 1000 or np.abs(w.max()) > 1000:
            alert.append("*** Overflow?")
        rows.append((name, str(w.shape), f"{w.min():+9.4f}", f"{w.max():+9.4f}",
                     f"{w.std():+9.4f}", " ".join(alert)))
    for r in rows:
        print("{:<50} {:>20} {:>10} {:>10} {:>10} {}".format(*r))
    return rows
