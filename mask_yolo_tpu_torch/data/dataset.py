"""Dataset registry — a copy of `mask_yolo_tpu/data/dataset.py`.

The reference depends on the external matterport `mrcnn.utils.Dataset` class
for its dataset abstraction (imported at reference myolo/myolo_utils.py:4
and used by example/shapes/dataset_shapes.py:53 and example/rice/rice_dataset.py:89).
This module provides the same surface natively: add_class / add_image /
prepare / image_ids / image_info / class_names / num_classes / load_image /
load_mask / image_reference / source_class_ids, plus the
`non_max_suppression` helper the Shapes generator uses
(dataset_shapes.py:178).
"""

from __future__ import annotations

import numpy as np


class Dataset:
    """Base dataset registry. Subclass and implement load_image/load_mask.

    Typical usage (identical to the reference flow):
        d = MyDataset()
        d.load_things(...)   # calls add_class / add_image
        d.prepare()
        image = d.load_image(image_id)
        masks, class_ids = d.load_mask(image_id)
    """

    def __init__(self, class_map=None):
        self._image_ids = []
        self.image_info = []
        # Background is always the first class
        self.class_info = [{"source": "", "id": 0, "name": "BG"}]
        self.source_class_ids = {}

    def add_class(self, source, class_id, class_name):
        assert "." not in source, "Source name cannot contain a dot"
        for info in self.class_info:
            if info["source"] == source and info["id"] == class_id:
                return  # already registered
        self.class_info.append({"source": source, "id": class_id, "name": class_name})

    def add_image(self, source, image_id, path, **kwargs):
        image_info = {"id": image_id, "source": source, "path": path}
        image_info.update(kwargs)
        self.image_info.append(image_info)

    def image_reference(self, image_id):
        """Return a link/identifier for debugging. Override as needed."""
        return ""

    def prepare(self, class_map=None):
        """Build internal lookup tables. Call after all add_class/add_image."""

        def clean_name(name):
            return ",".join(name.split(",")[:1])

        self.num_classes = len(self.class_info)
        self.class_ids = np.arange(self.num_classes)
        self.class_names = [clean_name(c["name"]) for c in self.class_info]
        self.num_images = len(self.image_info)
        self._image_ids = np.arange(self.num_images)

        # Map source-qualified class/image keys to internal contiguous IDs
        self.class_from_source_map = {
            "{}.{}".format(info["source"], info["id"]): idx
            for info, idx in zip(self.class_info, self.class_ids)
        }
        self.image_from_source_map = {
            "{}.{}".format(info["source"], info["id"]): idx
            for info, idx in zip(self.image_info, self._image_ids)
        }

        self.sources = list({i["source"] for i in self.class_info})
        self.source_class_ids = {}
        for source in self.sources:
            self.source_class_ids[source] = []
            for i, info in enumerate(self.class_info):
                if i == 0 or source == info["source"]:
                    self.source_class_ids[source].append(i)

    def map_source_class_id(self, source_class_id):
        return self.class_from_source_map[source_class_id]

    def get_source_class_id(self, class_id, source):
        info = self.class_info[class_id]
        assert info["source"] == source
        return info["id"]

    @property
    def image_ids(self):
        return self._image_ids

    def source_image_link(self, image_id):
        return self.image_info[image_id].get("path", "")

    def load_image(self, image_id):
        """Load an RGB uint8 [H, W, 3] image. Default: read from 'path'."""
        from PIL import Image

        path = self.image_info[image_id]["path"]
        image = np.asarray(Image.open(path))
        if image.ndim != 3:
            image = np.stack([image] * 3, axis=-1)
        if image.shape[-1] == 4:
            image = image[..., :3]
        return image

    def load_mask(self, image_id):
        """Return (masks [H, W, N] bool, class_ids [N] int32). Override."""
        return (
            np.empty([0, 0, 0], dtype=bool),
            np.empty([0], dtype=np.int32),
        )


def compute_iou_xyxy(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one box [x1,y1,x2,y2] against N boxes [N,4] (pixel coords)."""
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area + areas - inter
    return inter / np.maximum(union, 1e-10)


def non_max_suppression(boxes: np.ndarray, scores: np.ndarray, threshold: float):
    """Greedy NMS over [N, (x1,y1,x2,y2)] boxes; returns kept indices.

    Replaces mrcnn.utils.non_max_suppression used by the Shapes GT-overlap
    pruning (reference dataset_shapes.py:178).
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if boxes.size == 0:
        return np.empty((0,), dtype=np.int64)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = compute_iou_xyxy(boxes[i], boxes[order[1:]])
        order = order[1:][ious <= threshold]
    return np.asarray(keep, dtype=np.int64)
