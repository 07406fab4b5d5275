"""MaskYOLO — the user-facing class, inference mode only so far.

Port of the inference surface of `mask_yolo_tpu/model.py`: the constructor,
`detect` (one uint8 image → boxes, classes, scores and full-size masks) and
`detect_batch` (the throughput path), `load_jax_variables` to run the JAX
package's weights, and `quantize`, which switches `detect`/`detect_batch` to
the int8 path (quant.py). Training, `infer_yolo`, checkpoints and
`visualize` come with later slices (ROADMAP Queue 1).

The model keeps an f32 host copy of its weights (`_host_state`, a torch
state_dict of numpy arrays): the seeded draws, or the loaded flax tree. A
bf16 model's parameters are rounded copies, and `quantize` folds BatchNorm
into the f32 weights, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pipelines, weights
from .models.network import MaskYoloNet
from .quant import QuantizedDetector


class MaskYOLO:
    def __init__(self, mode, config, seed: int = 0, device="cpu"):
        if mode != "inference":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet; only 'inference' "
                "(ROADMAP Queue 1: training, yolo)")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        h, w = config.IMAGE_SHAPE[:2]
        if h % 32 or w % 32:
            raise ValueError("Image size must be divisible by 32 "
                             "(e.g. 224, 256, 288, 320, ...)")
        if config.GRID_H != h // 32 or config.GRID_W != w // 32:
            raise ValueError(f"GRID_{{H,W}}={config.GRID_H},{config.GRID_W} must "
                             f"equal IMAGE_SHAPE/32={h // 32},{w // 32}")
        self.mode, self.config, self.seed, self.device = mode, config, seed, device
        self._qdet = None

        def build(compute_dtype):
            return MaskYoloNet(
                num_classes=config.NUM_CLASSES,
                n_box=config.N_BOX,
                top_feature_map_depth=config.TOP_FEATURE_MAP_DEPTH,
                mask_pool_size=config.MASK_POOL_SIZE,
                backbone=config.BACKBONE,
                compute_dtype=compute_dtype,
            )

        # draw the seeded weights in f32, keep them, then load them into the
        # compute-dtype network (the same rounding as drawing into it)
        f32 = build("float32")
        f32.reset_parameters(torch.Generator().manual_seed(seed))
        self._host_state = {k: v.numpy().copy() for k, v in f32.state_dict().items()}
        self.net = build(config.COMPUTE_DTYPE)
        self.net.load_state_dict(f32.state_dict())
        self.net.to(device=device, memory_format=torch.channels_last).eval()

    def load_jax_variables(self, variables):
        """Load a flax variable tree of `mask_yolo_tpu.MaskYoloNet` (numpy
        leaves, e.g. `jax.device_get(model.variables)`)."""
        state = weights.from_jax_variables(variables, self.net.state_dict().keys())
        self.net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        self._host_state = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
                            for k, v in state.items()}
        self._qdet = None   # the int8 graph snapshots the old weights

    def quantize(self, calib_images, finetune_steps: int = 0):
        """Switch detect/detect_batch to the int8 path (post-training
        quantization, quant.py). calib_images: [N, H, W, 3] uint8 (divided
        by 255) or float in [0, 1], for the activation-range calibration,
        which runs on the model's device. The config's QUANT_* switches pick
        the kernels (QUANT_DW_INT8 + QUANT_FUSED_DS: K1; QUANT_FUSED_MASK:
        K3). A later load_jax_variables drops the int8 detector."""
        if finetune_steps:
            raise NotImplementedError(
                "quantization-aware finetune is not ported yet (ROADMAP Queue 1 item 10)")
        calib = calib_images
        if not torch.is_tensor(calib):
            calib = torch.from_numpy(np.ascontiguousarray(calib))
        calib = calib.to(self.device)
        if not calib.is_floating_point():
            calib = calib.float() / 255.0
        self._qdet = QuantizedDetector.from_variables(
            weights.to_jax_variables(self._host_state), self.config, calib,
            device=self.device)
        return self._qdet

    def _images(self, images):
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if list(images.shape[1:]) != list(self.config.IMAGE_SHAPE):
            raise ValueError(f"expected images [B, {self.config.IMAGE_SHAPE}], "
                             f"got {list(images.shape)}")
        return images.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def detect_batch(self, images):
        """[B, H, W, 3] uint8, or float in [0, 1] (numpy or tensor) → the
        fixed-shape dict of tensors on the model's device (see
        pipelines.detect_outputs); the int8 path after quantize()."""
        if self._qdet is not None:
            return self._qdet.detect_outputs(self._images(images))
        return pipelines.detect_outputs(self.net, self._images(images), self.config)

    def detect(self, image, cs_threshold=0.35, display=False):
        """One uint8 [H, W, 3] image → [{bboxes, class_ids,
        confidence_scores, full_masks [H, W, N]}] as numpy arrays."""
        if display:
            raise NotImplementedError("visualize is not ported yet (ROADMAP Queue 1)")
        image = np.asarray(image)
        if image.dtype != np.uint8:
            raise ValueError(f"expected a uint8 image, got {image.dtype}")
        out = {k: v.cpu().numpy() for k, v in self.detect_batch(image[None]).items()}
        idx = np.where(out["valid"][0] & (out["scores"][0] >= cs_threshold))[0]
        return [{
            "bboxes": out["boxes"][0][idx],
            "class_ids": out["classes"][0][idx],
            "confidence_scores": out["scores"][0][idx],
            "full_masks": np.transpose(out["masks"][0][idx], (1, 2, 0)),
        }]
