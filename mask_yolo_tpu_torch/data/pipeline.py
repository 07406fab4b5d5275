"""Batch generation: dataset → fixed-shape numpy batches — a copy of the
preload path of `mask_yolo_tpu/data/pipeline.py` (`preload_dataset`,
`BatchGenerator`). The endless `data_generator`, `GeneratorEpochSource` and
the pooled loader workers come with augmentation (ROADMAP Queue 1,
augmentation, pooled data workers and native image ops); the generator's
norm=False debug drawing comes with visualize.

Replaces the reference's BatchGenerator(Sequence)
(reference myolo/myolo_utils.py:689-860). Same contract — indexable,
len() = ceil(N / batch), shuffle between epochs, emits 'yolo'-mode
(image, true_boxes, yolo_target) or 'training'-mode (+ gt_class_ids,
gt_boxes, gt_masks) batches — but the per-instance target encoding is the
vectorized encoder (data/encoder.py) and all outputs are padded to fixed
shapes, the same for every batch.
"""

from __future__ import annotations

import numpy as np

from .encoder import encode_batch
from .loader import load_image_gt, pack_gt


def preload_dataset(dataset, config, image_ids=None, augment=False,
                    augmentation=None, seed=0):
    """Eagerly load + pack every image of a dataset (the reference preloads
    in train(), model.py:993-1006 — but hardcodes 50/6 counts; we load all).

    Returns dict of stacked arrays:
      images [N,H,W,3] uint8 (pipelines normalize on device — 4× less
      host→device transfer than float32), gt_class_ids [N,G],
      gt_boxes [N,G,4], gt_masks [H,W,G] bool (MINI_MASK_SHAPE-sized when
      config.USE_MINI_MASK).
    """
    rng = np.random.RandomState(seed)
    if image_ids is None:
        image_ids = dataset.image_ids
    images, all_ids, all_boxes, all_masks = [], [], [], []
    for image_id in image_ids:
        image, cids, boxes, masks = load_image_gt(
            dataset, config, image_id, augment=augment,
            augmentation=augmentation, rng=rng)
        ids, bxs, msks = pack_gt(cids, boxes, masks, config, rng=rng)
        images.append(np.ascontiguousarray(image, dtype=np.uint8))
        all_ids.append(ids)
        all_boxes.append(bxs)
        all_masks.append(msks)
    return {
        "images": np.stack(images),
        "gt_class_ids": np.stack(all_ids),
        "gt_boxes": np.stack(all_boxes),
        "gt_masks": np.stack(all_masks),
    }


class BatchGenerator:
    """Fixed-shape batch source over a preloaded dataset dict."""

    def __init__(self, data: dict, config, mode: str = "training",
                 shuffle: bool = True, seed: int | None = None):
        if mode not in ("yolo", "training"):
            raise ValueError(f"mode must be 'yolo' or 'training', got {mode!r}")
        self.data = data
        self.config = config
        self.mode = mode
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.n = data["images"].shape[0]
        self.order = np.arange(self.n)
        if shuffle:
            self.rng.shuffle(self.order)

    def __len__(self):
        return int(np.ceil(self.n / self.config.BATCH_SIZE))

    def on_epoch_end(self):
        if self.shuffle:
            self.rng.shuffle(self.order)

    def size(self):
        return self.n

    def num_classes(self):
        return self.config.NUM_CLASSES

    def __getitem__(self, idx):
        bs = self.config.BATCH_SIZE
        lo = idx * bs
        hi = min((idx + 1) * bs, self.n)
        if hi - lo < bs:  # keep batches full & static (reference wraps the
            lo = max(0, hi - bs)  # window back, myolo_utils.py:731-733)
        ids = self.order[lo:hi]
        if ids.shape[0] < bs:  # dataset smaller than a batch: tile
            ids = np.resize(ids, bs)

        images = self.data["images"][ids]
        gt_ids = self.data["gt_class_ids"][ids]
        gt_boxes = self.data["gt_boxes"][ids]
        yolo_target, true_boxes = encode_batch(gt_boxes, gt_ids, self.config)

        batch = {
            "image": images,
            "true_boxes": true_boxes,
            "yolo_target": yolo_target,
        }
        if self.mode == "training":
            batch["gt_class_ids"] = gt_ids
            batch["gt_boxes"] = gt_boxes.astype(np.float32)
            batch["gt_masks"] = self.data["gt_masks"][ids]
        return batch
