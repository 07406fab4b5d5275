"""The Shapes operating point — `ShapesConfig` from `mask_yolo_tpu/data/shapes.py`.

Only the configuration is ported so far; the synthetic dataset generator
(`ShapesDataset`) comes with the training slice.
"""

from __future__ import annotations

from ..config import Config


class ShapesConfig(Config):
    """Config for the toy Shapes dataset: 224² images, 3 classes + background,
    a 7×7×3 anchor grid."""

    NAME = "shapes"
    LABELS = ["background", "square", "circle", "triangle"]
    BATCH_SIZE = 16
    NUM_CLASSES = 1 + 3
    IMAGE_MIN_DIM = 224
    IMAGE_MAX_DIM = 224
    ANCHORS = [1.27273, 1.277385, 2.47446, 2.56253, 4.03843, 4.07434]
    N_BOX = 3
    TRAIN_ROIS_PER_IMAGE = Config.GRID_H * Config.GRID_W * 3
    # mini-masks: 56²-cropped GT masks instead of full 224² canvases
    USE_MINI_MASK = True
    # mask branch on the 32 best assignment slots during training
    MASK_TRAIN_TOP_ROIS = 32
    # train BN in batch-stats mode: Shapes trains from scratch
    TRAIN_BN = True
