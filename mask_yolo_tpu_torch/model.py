"""MaskYOLO — the user-facing class, port of `mask_yolo_tpu/model.py`.

Modes, as in the JAX package:
  "training"   `train` the full network (YOLO loss + mask loss);
  "yolo"       `train` the backbone and YOLO head on the YOLO loss alone;
  "inference"  `detect` / `detect_batch` / `infer_yolo`, and `quantize` for
               the int8 path (which then serves all three).

Weights: a training or yolo model starts from flax's default initializers
(LeCun-normal kernels, as the JAX package's `net.init`), drawn from the
seeded torch generator; an inference model from seeded He-normal kernels,
which give spread scores and masks for the smoke runs
(`models/network.py`). `load_jax_variables` loads the JAX package's weights,
`load_weights` a checkpoint of `train` or `save_weights`.

A training or yolo model holds float32 parameters whatever COMPUTE_DTYPE is
and casts them to it at each use, as flax does (`param_dtype=float32`): with
COMPUTE_DTYPE "bfloat16" the convolutions and the crop run in bf16, Adam
updates the f32 masters, and checkpoints hold the masters. An inference
model holds its parameters in the compute dtype and pays no cast.

The model keeps an f32 host copy of its weights (`_host_state`, a torch
state_dict of numpy arrays), which `quantize` folds as the JAX package does;
`train`, `load_weights` and `load_jax_variables` refresh it and drop the
int8 detector, which snapshots the old weights.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil

import numpy as np
import torch

from . import pipelines, weights
from .data.pipeline import (BatchGenerator, GeneratorEpochSource, data_generator,
                            preload_dataset)
from .data.prefetch import to_device
from .models.network import MaskYoloNet
from .quant import QuantizedDetector
from .train import state as state_lib
from .train import trainer as trainer_lib
from .utils.host_ops import BoundBox, unmold_mask

_NO_VISUALIZE = ("display=True needs utils/visualize.py, which is not ported yet "
                 "(ROADMAP Queue 1 #5, item 8: the rest of the MaskYOLO facade)")


class MaskYOLO:
    def __init__(self, mode, config, model_dir=None, yolo_pretrain_dir=None,
                 yolo_trainable=True, seed: int = 0, device="cuda"):
        if mode not in ("training", "inference", "yolo"):
            raise ValueError(f"mode must be 'training', 'inference' or 'yolo', got {mode!r}")
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
        self.model_dir = model_dir or "./checkpoints"
        self.yolo_trainable = yolo_trainable
        self.epoch = 0
        self._qdet = None
        self._tx = None
        self._train_step = None
        self._layer_regex = ".*"

        def build(compute_dtype, param_dtype=None):
            return MaskYoloNet(
                num_classes=config.NUM_CLASSES,
                n_box=config.N_BOX,
                top_feature_map_depth=config.TOP_FEATURE_MAP_DEPTH,
                mask_pool_size=config.MASK_POOL_SIZE,
                backbone=config.BACKBONE,
                compute_dtype=compute_dtype,
                param_dtype=param_dtype,
            )

        # draw the seeded weights in f32, keep them, then load them into the
        # network: f32 masters for training, the compute dtype for inference
        # (the same rounding as drawing into it)
        f32 = build("float32")
        generator = torch.Generator().manual_seed(seed)
        if mode == "inference":
            f32.reset_parameters(generator)
        else:
            f32.init_flax_defaults(generator)
        self._host_state = {k: v.numpy().copy() for k, v in f32.state_dict().items()}
        self.net = build(config.COMPUTE_DTYPE,
                         None if mode == "inference" else "float32")
        self.net.load_state_dict(f32.state_dict())
        self.net.to(device=device, memory_format=torch.channels_last).eval()

        if yolo_pretrain_dir is not None:
            if str(yolo_pretrain_dir).endswith((".h5", ".hdf5")):
                raise NotImplementedError(
                    "Keras h5 weights are not ported yet (ROADMAP Queue 1 item 8, "
                    "MaskYOLO facade: load_weights including Keras h5)")
            self.load_weights(yolo_pretrain_dir, by_name=True)

    # -- training ------------------------------------------------------------

    def compile(self, learning_rate, momentum=None, layer_regex: str = ".*",
                total_steps: int = 0):
        """Create the optimizer (the JAX package's optax chain, train/state.py)
        and the train step. `momentum` is accepted for signature parity;
        Adam ignores it. yolo_trainable=False freezes the backbone and the
        YOLO head, the whole image→YOLO-output path."""
        frozen = () if self.yolo_trainable else ("backbone", "yolo")
        self._tx = state_lib.make_optimizer(
            learning_rate, self.config, dict(self.net.named_parameters()),
            layer_regex=layer_regex, frozen_prefixes=frozen, total_steps=total_steps)
        self._train_step = trainer_lib.make_train_step(self.config, self._tx, self._loss_mode)

    @property
    def _loss_mode(self):
        return "training" if self.mode == "training" else "yolo"

    def set_trainable(self, layer_regex, **_):
        """Record the trainable-layer regex; applied at compile()."""
        self._layer_regex = layer_regex if isinstance(layer_regex, str) else ".*"

    def train(self, train_dataset, val_dataset, learning_rate, epochs,
              layers="all", augmentation=None, custom_callbacks=None,
              no_augmentation_sources=None, verbose=True, profile_dir=None,
              resume_from=None, stop_after_epoch=None):
        """Train (the JAX package's signature).

        Without `augmentation` the train set is preloaded once and batched
        by a `BatchGenerator`; with it (a `data/augment.py` augmenter, a
        bare callable or an imgaug-style object) every epoch draws
        len(train) // BATCH_SIZE batches from the endless `data_generator`,
        which re-reads and re-augments each image, on DATA_WORKERS loader
        workers when that is positive. profile_dir: a `torch.profiler`
        trace of a few steps of the first epoch is written there.

        Each epoch runs min(STEPS_PER_EPOCH, batches) steps (all batches when
        STEPS_PER_EPOCH is 0), then validates on min(VALIDATION_STEPS,
        batches) batches with BatchNorm on its running statistics, writes a
        checkpoint `saved_model_<time>_e<epoch>.pt` into model_dir (keeping
        the newest MAX_CHECKPOINTS), appends the epoch's metrics to
        history.jsonl and calls each cb(epoch, train_metrics, val_loss,
        state) of custom_callbacks. config.json in model_dir records the
        config.

        resume_from: a checkpoint of an earlier train(); restores params, BN
        statistics, optimizer moments, step and epoch, then continues to
        `epochs`. stop_after_epoch: return once that epoch's checkpoint is
        written, while the schedules still see the full `epochs` horizon.
        """
        if max(int(self.config.DATA_PARALLEL or 0), int(self.config.MODEL_PARALLEL or 1)) > 1:
            raise NotImplementedError(
                "multi-device training is not ported yet (ROADMAP Queue 1 item 11, "
                "parallel: DDP over NCCL)")
        layer_regex = {"all": ".*"}.get(layers, layers)
        mode = self._loss_mode
        if augmentation is not None:
            # floor, not ceil: data_generator emits full batches only (the
            # remainder rolls into the next pull), so ceil would drift the
            # epoch boundary off the dataset pass and its shuffle point
            steps = max(1, len(train_dataset.image_ids) // self.config.BATCH_SIZE)
            train_gen = GeneratorEpochSource(
                data_generator(train_dataset, self.config, shuffle=True,
                               augmentation=augmentation, mode=mode),
                steps, self.config)
        else:
            train_gen = BatchGenerator(preload_dataset(train_dataset, self.config),
                                       self.config, mode=mode, shuffle=True, seed=self.seed)
        val_gen = BatchGenerator(preload_dataset(val_dataset, self.config), self.config,
                                 mode=mode, shuffle=False)

        self.set_trainable(layer_regex)
        steps_cap = int(getattr(self.config, "STEPS_PER_EPOCH", 0) or 0)
        steps_per_epoch = min(steps_cap, len(train_gen)) if steps_cap else len(train_gen)
        self.compile(learning_rate, self.config.LEARNING_MOMENTUM, layer_regex=layer_regex,
                     total_steps=max(1, epochs * steps_per_epoch))
        self._invalidate_infer_fns()   # the weights are about to change

        state = state_lib.create_train_state(self.net, self._tx)
        if resume_from is not None:
            state, self.epoch = state_lib.resume_train_state(resume_from, state, self._tx)
            if verbose:
                print(f"Resumed from {resume_from} at epoch {self.epoch}")
        eval_step = trainer_lib.make_eval_step(self.config, mode)

        os.makedirs(self.model_dir, exist_ok=True)
        with open(os.path.join(self.model_dir, "config.json"), "w") as f:
            json.dump({k: v for k, v in self.config.to_dict().items()
                       if isinstance(v, (int, float, str, bool, list, tuple, dict, type(None)))},
                      f, indent=2, default=str)
        val_steps = int(getattr(self.config, "VALIDATION_STEPS", 0) or 0)
        n_val = min(len(val_gen), val_steps) if val_steps > 0 else len(val_gen)
        start_epoch = self.epoch
        try:
            for epoch in range(start_epoch, epochs):
                if verbose:
                    print(f"Epoch {epoch + 1}/{epochs}")
                state, metrics = trainer_lib.run_epoch(
                    self._train_step, state, train_gen, verbose=verbose,
                    profile_dir=profile_dir if epoch == start_epoch else None,
                    max_steps=steps_cap)
                train_gen.on_epoch_end()

                val = [eval_step(state, to_device(val_gen[i], self.device))["loss"]
                       for i in range(n_val)]
                val_loss = float(np.mean(torch.stack(val).cpu().numpy())) if val else float("nan")
                if verbose:
                    print(f"  train: {metrics}  val_loss: {val_loss:.4f}")

                ckpt_path = os.path.join(
                    self.model_dir, "saved_model_" + datetime.datetime.now().strftime(
                        "%b%d-%H-%M-%S") + f"_e{epoch + 1:04d}.pt")
                state_lib.save_checkpoint(ckpt_path, state, epoch=epoch + 1)
                self._rotate_checkpoints()
                self.epoch = epoch + 1
                with open(os.path.join(self.model_dir, "history.jsonl"), "a") as f:
                    f.write(json.dumps({"epoch": epoch + 1, "val_loss": val_loss,
                                        **metrics}) + "\n")
                for cb in custom_callbacks or ():
                    cb(epoch, metrics, val_loss, state)
                if stop_after_epoch is not None and epoch + 1 >= stop_after_epoch:
                    if verbose:
                        print(f"Stopping after epoch {epoch + 1} "
                              f"(stop_after_epoch; target {epochs})")
                    break
        finally:
            if augmentation is not None:
                train_gen.gen.close()   # stops the loader workers
            self.net.eval()
            self._sync_host_state()
        return state

    def _rotate_checkpoints(self):
        """Keep only the newest MAX_CHECKPOINTS epoch checkpoints (0 keeps
        all)."""
        keep = int(getattr(self.config, "MAX_CHECKPOINTS", 0) or 0)
        if keep <= 0:
            return
        paths = [os.path.join(self.model_dir, d) for d in os.listdir(self.model_dir)
                 if d.startswith("saved_model_")]
        for stale in sorted(paths, key=lambda p: (os.path.getmtime(p), p))[:-keep]:
            if os.path.isdir(stale):
                shutil.rmtree(stale, ignore_errors=True)
            else:
                os.remove(stale)

    # -- checkpoint I/O --------------------------------------------------------

    def save_weights(self, filepath):
        """Write params and BatchNorm statistics (no optimizer state) as a
        checkpoint that load_weights and resume_from read."""
        state_lib.save_checkpoint(filepath, state_lib.TrainState(self.net, {}, 0),
                                  epoch=self.epoch)

    def load_weights(self, filepath, by_name=False, exclude=None):
        """Restore params and BatchNorm statistics from a checkpoint, with the
        JAX package's by_name/exclude semantics: by_name replaces only the
        top-level modules (backbone, feature_map, yolo, mask) found in the
        file, exclude skips the named ones."""
        self._invalidate_infer_fns()
        ckpt = state_lib.load_checkpoint(filepath)
        current = state_lib.TrainState(self.net, {}, 0)
        params = state_lib.merge_params(current.params, ckpt["params"],
                                        by_name=by_name, exclude=exclude)
        stats = current.batch_stats
        if ckpt.get("batch_stats"):
            stats = state_lib.merge_params(stats, ckpt["batch_stats"],
                                           by_name=by_name, exclude=exclude)
        state_lib.load_into(self.net, params, stats)
        self._sync_host_state()

    def _sync_host_state(self):
        """The f32 host copy of the weights (of the masters, for a training
        model)."""
        self._host_state = {k: v.detach().float().cpu().numpy() if v.is_floating_point()
                            else v.detach().cpu().numpy()
                            for k, v in self.net.state_dict().items()}

    def _load_live_state(self, params, batch_stats):
        """Copy live tensors (a TrainState's parameters and BatchNorm
        statistics) into the network, device to device, cast to its dtypes.
        The host copy is refreshed when `quantize` next needs it."""
        self._invalidate_infer_fns()
        state_lib.load_into(self.net, params, batch_stats)
        self._host_state = None

    def _invalidate_infer_fns(self):
        """Drop the int8 detector: it snapshots the weights, so any weight
        change (load_weights, train) must drop it or detect and infer_yolo
        would keep serving the stale graph."""
        self._qdet = None

    # -- inference -------------------------------------------------------------

    def load_jax_variables(self, variables):
        """Load a flax variable tree of `mask_yolo_tpu.MaskYoloNet` (numpy
        leaves, e.g. `jax.device_get(model.variables)`)."""
        state = weights.from_jax_variables(variables, self.net.state_dict().keys())
        self.net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        self._host_state = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
                            for k, v in state.items()}
        self._invalidate_infer_fns()

    def quantize(self, calib_images, finetune_steps: int = 0):
        """Switch detect/detect_batch/infer_yolo to the int8 path (post-training
        quantization, quant.py). calib_images: [N, H, W, 3] uint8 (divided
        by 255) or float in [0, 1], for the activation-range calibration,
        which runs on the model's device. The config's QUANT_* switches pick
        the kernels (QUANT_DW_INT8 + QUANT_FUSED_DS: K1; QUANT_FUSED_MASK:
        K3). A later load_jax_variables, load_weights or train drops the
        int8 detector."""
        if finetune_steps:
            raise NotImplementedError(
                "quantization-aware finetune is not ported yet (ROADMAP Queue 1 item 10)")
        calib = calib_images
        if not torch.is_tensor(calib):
            calib = torch.from_numpy(np.ascontiguousarray(calib))
        calib = calib.to(self.device)
        if not calib.is_floating_point():
            calib = calib.float() / 255.0
        if self._host_state is None:
            self._sync_host_state()
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
    def detect_batch(self, images, weights_dir=None):
        """[B, H, W, 3] uint8, or float in [0, 1] (numpy or tensor) → the
        fixed-shape dict of tensors on the model's device (see
        pipelines.detect_outputs); the int8 path after quantize().
        weights_dir: a checkpoint to load first."""
        if weights_dir is not None:
            self.load_weights(weights_dir)
        if self._qdet is not None:
            return self._qdet.detect_outputs(self._images(images))
        self.net.eval()
        return pipelines.detect_outputs(self.net, self._images(images), self.config)

    @torch.inference_mode()
    def _infer_yolo_batch(self, images):
        """[B, H, W, 3] uint8 or float in [0, 1] → pipelines.infer_yolo_outputs'
        dict of tensors on the model's device; the int8 trunk after
        quantize()."""
        if self._qdet is not None:
            return self._qdet.infer_yolo_outputs(self._images(images))
        self.net.eval()
        return pipelines.infer_yolo_outputs(self.net, self._images(images), self.config)

    def _one_image(self, image, weights_dir, display):
        if display:
            raise NotImplementedError(_NO_VISUALIZE)
        image = np.asarray(image)
        if image.dtype != np.uint8:
            raise ValueError(f"expected a uint8 image, got {image.dtype}")
        if weights_dir is not None:
            self.load_weights(weights_dir)
        return image[None]

    def infer_yolo(self, image, weights_dir=None, save_path="./img_results/",
                   display=False):
        """Detection-only inference on one uint8 [H, W, 3] image: a list of
        `BoundBox` (utils/host_ops.py: .xmin/.get_label()/.get_score() and
        dict access), normalized coordinates. After quantize() this serves
        the int8 trunk, like detect. save_path is where display=True will
        write its figure once visualize is ported; until then display=True
        raises (the JAX package's default is True)."""
        del save_path
        out = {k: v.cpu().numpy() for k, v in
               self._infer_yolo_batch(self._one_image(image, weights_dir, display)).items()}
        boxes = []
        for i in np.where(out["valid"][0])[0]:
            x1, y1, x2, y2 = out["boxes"][0, i]
            boxes.append(BoundBox(xmin=float(x1), ymin=float(y1), xmax=float(x2),
                                  ymax=float(y2), score=float(out["scores"][0, i]),
                                  label=int(out["classes"][0, i])))
        return boxes

    def detect(self, image, weights_dir=None, save_path="./img_results/",
               cs_threshold=0.35, display=False):
        """One uint8 [H, W, 3] image → [{bboxes, class_ids,
        confidence_scores, full_masks [H, W, N]}] as numpy arrays (the JAX
        package's parameters in its order; display=True raises until
        visualize is ported, so it defaults to False here)."""
        del save_path
        if self.mode != "inference":
            raise ValueError("detect needs a model in 'inference' mode")
        out = {k: v.cpu().numpy() for k, v in
               self.detect_batch(self._one_image(image, weights_dir, display)).items()}
        idx = np.where(out["valid"][0] & (out["scores"][0] >= cs_threshold))[0]
        return [{
            "bboxes": out["boxes"][0][idx],
            "class_ids": out["classes"][0][idx],
            "confidence_scores": out["scores"][0][idx],
            "full_masks": np.transpose(out["masks"][0][idx], (1, 2, 0)),
        }]

    def decode_masks(self, detections, myolo_mask, image_shape):
        """Host-side reformatting kept for API parity. detections:
        [1, N, 6] (pixel x1, y1, x2, y2, score, class); myolo_mask:
        [1, N, mh, mw, C]. Returns (boxes, class_ids, scores, full masks
        [H, W, N]) of the boxes with a positive area."""
        det = np.asarray(detections[0])
        masks = np.asarray(myolo_mask[0])
        n = det.shape[0]
        boxes = det[:, :4]
        scores = det[:, 4]
        class_ids = det[:, 5].astype(np.int32)
        sel = masks[np.arange(n), :, :, class_ids]
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = area > 0
        boxes, class_ids, scores, sel = (boxes[keep], class_ids[keep],
                                         scores[keep], sel[keep])
        full = [unmold_mask(m, b, image_shape) for m, b in zip(sel, boxes)]
        full = (np.stack(full, axis=-1) if full
                else np.empty(tuple(image_shape[:2]) + (0,)))
        return boxes, class_ids, scores, full
