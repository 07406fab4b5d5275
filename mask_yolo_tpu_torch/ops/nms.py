"""Non-max suppression — port of `mask_yolo_tpu/ops/nms.py`.

Every function is batched: leading dimensions take the place of the JAX
package's `vmap`s, and everything runs on the input's device in fixed
shapes ("dropped" boxes are zeroed scores, not shorter arrays).

Greedy NMS is a sequential chain over the score-sorted boxes. XLA unrolls
it into one program (and tiles it above 512 boxes, to the same result); in
eager PyTorch every step is a handful of launches, so `greedy_keep` runs
one chain for all images and classes at once ([M, C, N] state, a loop over
sorted positions, no host read inside) and stops after the longest run of
boxes with a positive score, which it reads from the device once before
the loop: boxes with a zero score sort last and never suppress, so the
steps beyond do nothing.

Order and ties follow XLA: sorts are stable (`jnp.argsort(-scores)`,
`lax.top_k` and `jnp.argmax` all take the lowest index on ties).
"""

from __future__ import annotations

import torch

from .boxes import box_iou_matrix


def stable_top_k(values, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    ties in index order (lax.top_k's order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def first_argmax(x):
    """(max, argmax) along the last axis, the lowest index on ties
    (jnp.argmax's), on every device."""
    top = x.amax(dim=-1)
    idx = torch.arange(x.shape[-1], device=x.device)
    first = torch.where(x == top[..., None], idx, x.shape[-1]).amin(dim=-1)
    return top, first


def greedy_keep(hit, scores):
    """The greedy chain. hit: [M, N, N] bool, hit[m, i, j] iff box i of set
    m suppresses box j when it outranks it (IoU >= threshold); scores:
    [M, C, N], C score columns over the same N boxes (0 = inactive: never a
    suppressor). Returns keep [M, C, N] bool aligned to the input: in
    descending score order (stable), a box that is still kept and active
    drops every box ranked after it that it hits.

    Each step notes whether its box is still alive and then lets it strike
    every box it hits, earlier ones too: their fate is already noted, so
    the chain needs no rank comparison (five launches a step).
    `greedy_keep.steps` holds the chain length of the last call."""
    m, c, n = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)            # [M, C, N]
    active = scores > 0.0
    active_s = torch.gather(active, -1, order)
    alive = torch.ones_like(active)
    # the one host read: the longest run of active boxes bounds the chain
    steps = min(n, int(active.sum(-1).max())) if scores.numel() else 0
    greedy_keep.steps = steps
    kept = []
    for i in range(steps):
        j = order[..., i:i + 1]                                      # [M, C, 1]
        kept.append(torch.gather(alive, -1, j))                      # alive at its turn?
        row = torch.gather(hit, 1, j.expand(m, c, n))                # hit[m, j, :]
        alive.masked_fill_(row & (kept[-1] & active_s[..., i:i + 1]), False)
    # boxes past the chain are inactive: they keep what the chain left them
    if steps:
        alive.scatter_(-1, order[..., :steps], torch.cat(kept, dim=-1))
    return alive


greedy_keep.steps = 0


def greedy_nms_mask(boxes, scores, iou_threshold: float):
    """Greedy score-ordered NMS. boxes: [..., N, 4] (x1, y1, x2, y2); scores:
    [..., N] (0 = inactive). Returns the bool keep-mask [..., N]: iterate in
    descending score order; a surviving box suppresses every later box with
    IoU >= threshold."""
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    hit = box_iou_matrix(boxes, boxes).reshape(-1, n, n) >= iou_threshold
    return greedy_keep(hit, scores.reshape(-1, 1, n)).reshape(*lead, n)


def class_aware_nms(boxes, class_scores, iou_threshold: float):
    """Per-class greedy NMS: zero the class score of suppressed boxes.
    boxes: [..., N, 4]; class_scores: [..., N, C]. Returns class_scores with
    suppressed entries zeroed. All classes share one IoU matrix."""
    n, c = class_scores.shape[-2:]
    lead = class_scores.shape[:-2]
    hit = box_iou_matrix(boxes, boxes).reshape(-1, n, n) >= iou_threshold
    keep = greedy_keep(hit, class_scores.reshape(-1, n, c).transpose(1, 2))
    keep = keep.transpose(1, 2).reshape(*lead, n, c)
    return class_scores * keep.to(class_scores.dtype)


def per_class_topk_nms(boxes, class_scores, k: int, iou_threshold: float):
    """class_aware_nms with per-class candidate compaction: each class's
    suppression runs over only its own top-k boxes by that class's score.
    Equal to class_aware_nms while every class has <= k boxes with a score
    > 0 (zeros neither suppress nor survive). boxes: [..., N, 4];
    class_scores: [..., N, C]; same contract as class_aware_nms."""
    n, c = class_scores.shape[-2:]
    if k >= n:
        return class_aware_nms(boxes, class_scores, iou_threshold)
    lead = class_scores.shape[:-2]
    scores = class_scores.reshape(-1, n, c).transpose(1, 2)          # [M, C, N]
    m = scores.shape[0]
    top_s, top_i = stable_top_k(scores, k)                           # [M, C, k]
    own = torch.gather(boxes.reshape(m, 1, n, 4).expand(m, c, n, 4), 2,
                       top_i[..., None].expand(m, c, k, 4))          # [M, C, k, 4]
    hit = box_iou_matrix(own, own).reshape(m * c, k, k) >= iou_threshold
    keep = greedy_keep(hit, top_s.reshape(m * c, 1, k)).reshape(m, c, k)
    kept = top_s * keep.to(top_s.dtype)
    out = torch.zeros_like(scores).scatter_(-1, top_i, kept)
    return out.transpose(1, 2).reshape(*lead, n, c)


def reference_softmax(x, axis: int = -1, t: float = -100.0, batch_dims: int = 0):
    """The reference's softmax: a shift by the global maximum and a rescale
    x / min · t when the shifted minimum is below t, then softmax along
    `axis`. The first `batch_dims` dimensions are independent calls (the
    JAX package calls it under `vmap` per image, so the maximum runs over
    one image's whole grid, not over the batch and not per box)."""
    rest = tuple(range(batch_dims, x.dim()))
    x = x - x.amax(dim=rest, keepdim=True)
    xmin = x.amin(dim=rest, keepdim=True)
    x = torch.where(xmin < t, x / xmin * t, x)
    e = torch.exp(x)
    return e / e.sum(dim=axis, keepdim=True)


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


def top_k_detections(boxes, scores, class_ids, k: int, score_threshold: float):
    """The top-k detections by score with a validity mask: (boxes [..., k, 4],
    scores [..., k], class_ids [..., k], valid [..., k])."""
    k = min(k, scores.shape[-1])
    top_scores, idx = stable_top_k(scores, k)
    return (torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4)), top_scores,
            torch.gather(class_ids, -1, idx), top_scores > score_threshold)
