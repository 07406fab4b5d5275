"""COCO-JSON instance-segmentation datasets — a copy of
`mask_yolo_tpu/data/coco.py`.

The BASELINE scale-out operating point is "batched 80-class COCO-style
inference at 416²" (BASELINE.md; config.CocoStyleConfig), but the reference
only ever ships a VIA-polygon loader (reference example/rice/
rice_dataset.py:104-159 — the pattern data/via.py rebuilds). This module adds
the loader that operating point actually needs: standard COCO annotation
JSON (images / annotations / categories) with all three segmentation
encodings — polygon lists, uncompressed RLE ({'counts': [...]}) and
compressed RLE ({'counts': '<str>'}) — decoded natively (no pycocotools
dependency; the compressed-RLE varint scheme is implemented from the format
definition).

Also provides `dataset_to_coco_json`, the inverse: export any Dataset
registry (e.g. the synthetic Shapes generator) to an on-disk COCO-style
dataset — which is how the 80-class pipeline is exercised end to end
without real COCO.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.image import polygon_mask
from .dataset import Dataset


# ---------------------------------------------------------------------------
# RLE codecs (COCO convention: column-major / Fortran order, counts
# alternating runs of 0s and 1s, starting with 0s)
# ---------------------------------------------------------------------------


def rle_decode_counts(counts, shape):
    """Uncompressed COCO RLE counts → bool mask [h, w] (column-major runs)."""
    h, w = shape
    flat = np.zeros(h * w, dtype=bool)
    pos, val = 0, False
    for c in counts:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    return flat.reshape((w, h)).T  # column-major


def rle_encode(mask):
    """Bool mask [h, w] → uncompressed COCO RLE counts (column-major)."""
    flat = np.asarray(mask, dtype=bool).T.ravel()  # column-major
    if flat.size == 0:
        return []
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0]:
        runs = [0] + runs
    return [int(r) for r in runs]


def rle_from_string(s):
    """COCO compressed-RLE string → counts list.

    The format packs each count as a little-endian base-32 varint (5 value
    bits + 1 continuation bit per character, offset from ASCII 48), sign-
    extended when the top value bit of the final character is set; counts
    from index 3 on are delta-coded against counts[i-2]."""
    counts = []
    i = 0
    while i < len(s):
        x, k = 0, 0
        while True:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:  # sign-extend
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_segmentation(seg, shape):
    """Any COCO segmentation value → bool mask [h, w].

    seg: list of flat polygons [[x1, y1, x2, y2, ...], ...], or an RLE dict
    {'size': [h, w], 'counts': list|str}."""
    h, w = shape
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, str):
            counts = rle_from_string(counts)
        return rle_decode_counts(counts, tuple(seg.get("size", (h, w))))
    mask = np.zeros((h, w), dtype=bool)
    for poly in seg:
        xs = np.asarray(poly[0::2], dtype=np.float64)
        ys = np.asarray(poly[1::2], dtype=np.float64)
        if len(xs) >= 3:
            mask |= polygon_mask(xs, ys, (h, w))
    return mask


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class CocoDataset(Dataset):
    """Dataset backed by a COCO-style annotation JSON.

    Usage:
        d = CocoDataset()
        d.load_coco("annotations/instances_val.json", "images/val")
        d.prepare()
    """

    def load_coco(self, annotation_file, image_dir, class_ids=None,
                  include_crowd=False, source="coco"):
        """Register classes and images from a COCO annotation JSON.

        class_ids: optional list of COCO category ids to restrict to.
        include_crowd: keep iscrowd=1 annotations (off by default — crowd
        RLEs are ambiguous instance targets for a detector of this size).
        """
        self.source = source
        with open(annotation_file) as f:
            coco = json.load(f)

        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        if class_ids is not None:
            keep = set(class_ids)
            cats = [c for c in cats if c["id"] in keep]
        cat_ids = {c["id"] for c in cats}
        for c in cats:
            self.add_class(source, c["id"], c["name"])

        anns_by_image: dict = {}
        for a in coco.get("annotations", []):
            if a["category_id"] not in cat_ids:
                continue
            if a.get("iscrowd", 0) and not include_crowd:
                continue
            anns_by_image.setdefault(a["image_id"], []).append(a)

        for img in coco.get("images", []):
            anns = anns_by_image.get(img["id"], [])
            if not anns:
                continue  # images without annotations carry no signal
            self.add_image(
                source,
                image_id=img["id"],
                path=os.path.join(image_dir, img["file_name"]),
                width=img["width"],
                height=img["height"],
                annotations=anns,
            )

    def load_mask(self, image_id):
        info = self.image_info[image_id]
        if info["source"] != getattr(self, "source", "coco"):
            return super().load_mask(image_id)
        h, w = info["height"], info["width"]
        masks, ids = [], []
        for a in info["annotations"]:
            seg = a.get("segmentation")
            if seg:
                m = decode_segmentation(seg, (h, w))
            elif "bbox" in a:  # box-only annotation → rectangle mask
                x, y, bw, bh = a["bbox"]
                m = np.zeros((h, w), dtype=bool)
                m[int(y):int(np.ceil(y + bh)), int(x):int(np.ceil(x + bw))] = True
            else:
                continue
            if not m.any():
                continue
            masks.append(m)
            ids.append(self.map_source_class_id(
                f"{info['source']}.{a['category_id']}"))
        if not masks:
            return (np.empty((h, w, 0), dtype=bool),
                    np.empty([0], dtype=np.int32))
        return (np.stack(masks, axis=-1),
                np.asarray(ids, dtype=np.int32))

    def image_reference(self, image_id):
        return self.image_info[image_id].get("path", "")


# ---------------------------------------------------------------------------
# Exporter — any Dataset → on-disk COCO-style dataset
# ---------------------------------------------------------------------------


def dataset_to_coco_json(dataset, out_dir, annotation_name="instances.json",
                         image_format="png", write_images=True):
    """Materialize a prepared Dataset registry as a COCO-style dataset:
    <out_dir>/images/*.png + <out_dir>/<annotation_name> with uncompressed-RLE
    segmentations (valid COCO; every COCO consumer accepts RLE dicts).
    write_images=False writes the annotation file alone and needs no PIL
    (the JAX package's always writes the images).

    Returns the annotation file path.
    """
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir if write_images else out_dir, exist_ok=True)
    if write_images:
        from PIL import Image

    categories = [
        {"id": i, "name": name, "supercategory": "object"}
        for i, name in enumerate(dataset.class_names)
        if i > 0  # background is not a COCO category
    ]
    images, annotations = [], []
    ann_id = 1
    for image_id in dataset.image_ids:
        image = dataset.load_image(image_id)
        masks, class_ids = dataset.load_mask(image_id)
        h, w = image.shape[:2]
        fname = f"{int(image_id):06d}.{image_format}"
        if write_images:
            Image.fromarray(image).save(os.path.join(img_dir, fname))
        images.append({"id": int(image_id), "file_name": fname,
                       "width": w, "height": h})
        for i in range(masks.shape[-1]):
            m = masks[..., i].astype(bool)
            ys, xs = np.nonzero(m)
            if xs.size == 0:
                continue
            bbox = [float(xs.min()), float(ys.min()),
                    float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]
            annotations.append({
                "id": ann_id,
                "image_id": int(image_id),
                "category_id": int(class_ids[i]),
                "segmentation": {"size": [h, w], "counts": rle_encode(m)},
                "bbox": bbox,
                "area": float(m.sum()),
                "iscrowd": 0,
            })
            ann_id += 1

    ann_path = os.path.join(out_dir, annotation_name)
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    return ann_path


def coco_category_map(categories_or_annotation_file):
    """internal class index (1..N, the contiguous ids `load_coco` assigns in
    sorted-category-id order) → original COCO category id. Pass either the
    annotation file path or its already-loaded "categories" list. Needed to
    score results against real COCO annotations, whose category ids are
    non-contiguous (1..90 with gaps); datasets materialized by
    `dataset_to_coco_json` use contiguous ids, where the map is identity."""
    cats = categories_or_annotation_file
    if isinstance(cats, str):
        with open(cats) as f:
            cats = json.load(f).get("categories", [])
    cats = sorted(cats, key=lambda c: c["id"])
    return {i + 1: int(c["id"]) for i, c in enumerate(cats)}


def detections_to_coco_results(image_id, boxes, class_ids, scores, masks=None,
                               scale=None, category_map=None):
    """Convert one image's detections to COCO "results"-format entries
    (the list-of-dicts format pycocotools' COCOeval.loadRes consumes).

    boxes: [N, 4] (x1, y1, x2, y2) pixels in the network frame;
    class_ids/scores: [N]; masks: optional [H, W, N] bool/float in the
    network frame. scale: optional (sy, sx) network-frame = original * scale
    (utils.image.resize_image's per-axis factors) — when given, boxes and
    masks are mapped back to the original image frame so the results score
    directly against the original annotations.

    category_map: optional {internal class index → source category id}
    (see coco_category_map). Without it the model's internal contiguous
    index is emitted — correct for datasets written by dataset_to_coco_json,
    WRONG against real COCO annotations whose ids have gaps.
    """
    from ..utils.image import resize_nearest

    boxes = np.asarray(boxes, np.float64)
    results = []
    for i in range(len(boxes)):
        x1, y1, x2, y2 = boxes[i]
        if scale is not None:
            sy, sx = float(scale[0]), float(scale[1])
            x1, x2, y1, y2 = x1 / sx, x2 / sx, y1 / sy, y2 / sy
        cid = int(class_ids[i])
        if category_map is not None:
            cid = int(category_map[cid])
        entry = {
            "image_id": int(image_id) if not isinstance(image_id, str) else image_id,
            "category_id": cid,
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "score": float(scores[i]),
        }
        if masks is not None:
            m = np.asarray(masks[..., i])
            m = m >= 0.5 if m.dtype != bool else m
            if scale is not None:
                m = resize_nearest(m.astype(np.uint8),
                                   (1.0 / float(scale[0]),
                                    1.0 / float(scale[1]))).astype(bool)
            entry["segmentation"] = {"size": list(m.shape[:2]),
                                     "counts": rle_encode(m)}
        results.append(entry)
    return results
