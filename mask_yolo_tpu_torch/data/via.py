"""VIA polygon-annotation datasets (Rice / Food) — a copy of
`mask_yolo_tpu/data/via.py`.

Rebuilds the reference's RiceDataset VIA loader
(reference example/rice/rice_dataset.py:60-170, duplicated for food at
example/food/rice_dataset.py): reads VIA 1.x/2.x JSON exports, converts each
region's polygon to a boolean instance mask. Polygon rasterization is our own
even-odd scanline fill (utils/image.polygon_mask) instead of
skimage.draw.polygon. Also ships the color_splash demo utility
(rice_dataset.py:193-230).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..config import Config
from ..utils.image import polygon_mask
from .dataset import Dataset


class ViaConfig(Config):
    """Single-class VIA dataset config (reference RiceConfig,
    rice_dataset.py:60-82)."""

    NAME = "food"
    LABELS = ["background", "food"]
    NUM_CLASSES = 1 + 1


class RiceConfig(ViaConfig):
    """Single-class rice config (reference rice_dataset.py:60-82)."""

    NAME = "rice"
    LABELS = ["background", "rice"]


class FoodConfig(ViaConfig):
    """Single-class food config (reference example/food/rice_dataset.py)."""

    NAME = "food"
    LABELS = ["background", "food"]


class ViaDataset(Dataset):
    """Dataset backed by a VIA polygon-annotation JSON export.

    Directory layout (matching reference datasets/{rice,food}):
        <dataset_dir>/<subset>/via_<name>_annotation.json
        <dataset_dir>/<subset>/<image files>
    """

    def __init__(self, source: str = "food", class_name: str = "food"):
        super().__init__()
        self.source = source
        self.class_name = class_name

    def load_via(self, dataset_dir, subset, annotation_file=None):
        self.add_class(self.source, 1, self.class_name)
        assert subset in ["train", "val"]
        dataset_dir = os.path.join(dataset_dir, subset)

        if annotation_file is None:
            candidates = [f for f in os.listdir(dataset_dir)
                          if f.startswith("via_") and f.endswith(".json")]
            assert candidates, f"no via_*.json in {dataset_dir}"
            annotation_file = candidates[0]

        with open(os.path.join(dataset_dir, annotation_file)) as f:
            annotations = list(json.load(f).values())
        # VIA saves entries for unannotated images too; skip them
        annotations = [a for a in annotations if a.get("regions")]

        for a in annotations:
            # VIA 1.x stores regions as a dict, 2.x as a list
            if isinstance(a["regions"], dict):
                polygons = [r["shape_attributes"] for r in a["regions"].values()]
            else:
                polygons = [r["shape_attributes"] for r in a["regions"]]

            image_path = os.path.join(dataset_dir, a["filename"])
            height, width = self._image_size(image_path)
            self.add_image(
                self.source,
                image_id=a["filename"],
                path=image_path,
                width=width,
                height=height,
                polygons=polygons,
            )

    @staticmethod
    def _image_size(image_path):
        """Image (height, width) — VIA JSON omits it (the reference reads the
        whole image; PIL reads just the header)."""
        from PIL import Image

        with Image.open(image_path) as im:
            w, h = im.size
        return h, w

    def load_mask(self, image_id):
        info = self.image_info[image_id]
        if info["source"] != self.source:
            return super().load_mask(image_id)
        n = len(info["polygons"])
        mask = np.zeros([info["height"], info["width"], n], dtype=bool)
        for i, p in enumerate(info["polygons"]):
            mask[:, :, i] = polygon_mask(
                p["all_points_x"], p["all_points_y"],
                (info["height"], info["width"]))
        return mask, np.ones([n], dtype=np.int32)

    def image_reference(self, image_id):
        info = self.image_info[image_id]
        if info["source"] == self.source:
            return info["path"]
        return super().image_reference(image_id)


class RiceDataset(ViaDataset):
    """Reference-compatible alias: load_rice(dataset_dir, subset)."""

    def __init__(self):
        super().__init__(source="rice", class_name="rice")

    def load_rice(self, dataset_dir, subset):
        self.load_via(dataset_dir, subset)


class FoodDataset(ViaDataset):
    """Reference-compatible alias: load_food(dataset_dir, subset)
    (the reference reuses a copy of rice_dataset.py for food,
    example/food/rice_dataset.py)."""

    def __init__(self):
        super().__init__(source="food", class_name="food")

    def load_food(self, dataset_dir, subset):
        self.load_via(dataset_dir, subset)


def color_splash(image, mask):
    """Gray out everything except masked regions (reference
    rice_dataset.py:193-212)."""
    gray = np.sum(image.astype(np.float32) *
                  np.array([0.299, 0.587, 0.114]), axis=-1, keepdims=True)
    gray = np.repeat(gray, 3, axis=-1).astype(np.uint8)
    if mask.shape[-1] > 0:
        keep = mask.any(axis=-1, keepdims=True)
        return np.where(keep, image, gray).astype(np.uint8)
    return gray
