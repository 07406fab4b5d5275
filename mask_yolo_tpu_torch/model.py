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

Parallel (parallel/): in a job of several processes (one device each,
joined by `parallel.distributed.initialize()`), `train` runs on the mesh
that `mesh` builds from DATA_PARALLEL and MODEL_PARALLEL: each rank trains
on its share of the data with BATCH_SIZE per process, the step equals the
single-process step on the global batch, and the chief writes the whole
checkpoints. `detect_batch(mesh=)` and `evaluate_dataset(mesh=)` detect
each rank's share. `export_model` writes the detect pipeline as a
`torch.export` artifact (export.py).
"""

from __future__ import annotations

import datetime
import json
import os
import shutil

import numpy as np
import torch

from . import export as export_lib
from . import pipelines, weights
from .data.pipeline import (BatchGenerator, GeneratorEpochSource, data_generator,
                            preload_dataset)
from .data.prefetch import to_device
from .models.network import MaskYoloNet
from .parallel import mesh as mesh_lib
from .parallel.distributed import local_image_ids
from .parallel.inference import ShardedDetector
from .quant import QuantizedDetector
from .train import state as state_lib
from .train import trainer as trainer_lib
from .utils.host_ops import BoundBox, unmold_mask


def _deep_merge_by_name(current, loaded, exclude: set, report: dict, _path: str = ""):
    """Leaf-wise by-name merge of `loaded` into `current` (Keras by_name
    semantics): a leaf is taken where the same path exists in `current` with
    the same shape; mismatches go to report['shape_mismatch'], unknown paths
    to report['skipped']."""
    if not isinstance(current, dict) or not isinstance(loaded, dict):
        cur, new = np.asarray(current), np.asarray(loaded)
        if cur.shape != new.shape:
            report["shape_mismatch"].append(f"{_path}: have {cur.shape}, file has {new.shape}")
            return current
        return new.astype(cur.dtype)
    merged = dict(current)
    for k, v in loaded.items():
        if k in exclude:
            continue
        if k in merged:
            merged[k] = _deep_merge_by_name(merged[k], v, exclude, report,
                                            f"{_path}/{k}" if _path else k)
        else:
            report.setdefault("skipped", []).append(f"{_path}/{k}")
    return merged


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
        self._mesh = None
        self._sharded_det = None
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
                image_hw=(h, w),
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
                report = self.load_weights_from_keras_h5(yolo_pretrain_dir)
                # a file that brings no YOLO-branch weights would leave a
                # random (and, with yolo_trainable=False, frozen) head
                if not any(p and p[0] == "yolo" for p in report.get("loaded_paths", ())):
                    raise ValueError(
                        f"{yolo_pretrain_dir} contained no YOLO-branch weights (loaded: "
                        f"{report['loaded']}, skipped: {report['skipped']})")
            else:
                self.load_weights(yolo_pretrain_dir, by_name=True)

    @property
    def mesh(self):
        """The (data, model) mesh over the job's ranks (parallel/mesh.py),
        built at first use; the global batch is BATCH_SIZE per process."""
        if self._mesh is None:
            world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
            self._mesh = mesh_lib.build_mesh(self.config,
                                             batch_size=int(self.config.BATCH_SIZE) * world)
        return self._mesh

    # -- training ------------------------------------------------------------

    def compile(self, learning_rate, momentum=None, layer_regex: str = ".*",
                total_steps: int = 0, mesh=None):
        """Create the optimizer (the JAX package's optax chain, train/state.py)
        and the train step. `momentum` is accepted for signature parity;
        Adam ignores it. yolo_trainable=False freezes the backbone and the
        YOLO head, the whole image→YOLO-output path. mesh: the step of a
        network placed on it (train)."""
        frozen = () if self.yolo_trainable else ("backbone", "yolo")
        self._tx = state_lib.make_optimizer(
            learning_rate, self.config, dict(self.net.named_parameters()),
            layer_regex=layer_regex, frozen_prefixes=frozen, total_steps=total_steps)
        self._train_step = trainer_lib.make_train_step(self.config, self._tx, self._loss_mode,
                                                       mesh=mesh)

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

        In a job of several processes every rank calls train with the same
        arguments. The mesh (`mesh`) splits the data by data index
        (`local_image_ids`; with `augmentation`, each data rank draws its
        own stream, seeded by its index), places the network (BatchNorm
        statistics over the data group; under MODEL_PARALLEL > 1 the wide
        convs sharded over the model group, their optimizer state too), and
        the step is the single-process step on the global batch. The metrics
        and the validation loss are the global batch's; the chief writes the
        whole checkpoints, config.json and history.jsonl, and the network is
        whole again when train returns.
        """
        layer_regex = {"all": ".*"}.get(layers, layers)
        mode = self._loss_mode
        distributed = torch.distributed.is_initialized()
        mesh = self.mesh   # checks DATA_PARALLEL and MODEL_PARALLEL against the ranks
        if not distributed:
            mesh = None    # one process: no collective to run
        chief = not distributed or torch.distributed.get_rank() == 0
        share = ((lambda ds: local_image_ids(ds.image_ids, mesh.data_index, mesh.dp))
                 if mesh is not None else (lambda ds: None))
        if augmentation is not None:
            # floor, not ceil: data_generator emits full batches only (the
            # remainder rolls into the next pull), so ceil would drift the
            # epoch boundary off the dataset pass and its shuffle point
            n_train = len(train_dataset.image_ids) // (mesh.dp if mesh is not None else 1)
            steps = max(1, n_train // self.config.BATCH_SIZE)
            train_gen = GeneratorEpochSource(
                data_generator(train_dataset, self.config, shuffle=True,
                               augmentation=augmentation, mode=mode,
                               seed=mesh.data_index if mesh is not None else 0),
                steps, self.config)
        else:
            train_gen = BatchGenerator(
                preload_dataset(train_dataset, self.config, image_ids=share(train_dataset)),
                self.config, mode=mode, shuffle=True, seed=self.seed)
        val_gen = BatchGenerator(preload_dataset(val_dataset, self.config,
                                                 image_ids=share(val_dataset)),
                                 self.config, mode=mode, shuffle=False)

        self._invalidate_infer_fns()   # the weights are about to change
        shardings = mesh_lib.place_network(self.net, mesh) if mesh is not None else None
        self.set_trainable(layer_regex)
        steps_cap = int(getattr(self.config, "STEPS_PER_EPOCH", 0) or 0)
        steps_per_epoch = min(steps_cap, len(train_gen)) if steps_cap else len(train_gen)
        self.compile(learning_rate, self.config.LEARNING_MOMENTUM, layer_regex=layer_regex,
                     total_steps=max(1, epochs * steps_per_epoch), mesh=mesh)
        if mesh is not None:
            self._tx.shard(shardings, mesh.model_group)

        state = state_lib.create_train_state(self.net, self._tx)
        if resume_from is not None:
            state, self.epoch = state_lib.resume_train_state(resume_from, state, self._tx,
                                                             mesh=mesh, shardings=shardings)
            if verbose:
                print(f"Resumed from {resume_from} at epoch {self.epoch}")
        eval_step = trainer_lib.make_eval_step(self.config, mode, mesh=mesh)

        os.makedirs(self.model_dir, exist_ok=True)
        if chief:
            with open(os.path.join(self.model_dir, "config.json"), "w") as f:
                json.dump({k: v for k, v in self.config.to_dict().items()
                           if isinstance(v, (int, float, str, bool, list, tuple, dict,
                                             type(None)))},
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

                stamp = datetime.datetime.now().strftime("%b%d-%H-%M-%S")
                if distributed:   # one name on every rank: the chief's
                    box = [stamp]
                    torch.distributed.broadcast_object_list(box, src=0)
                    stamp = box[0]
                ckpt_path = os.path.join(self.model_dir,
                                         f"saved_model_{stamp}_e{epoch + 1:04d}.pt")
                state_lib.save_checkpoint(ckpt_path, state, epoch=epoch + 1, mesh=mesh,
                                          shardings=shardings)
                self.epoch = epoch + 1
                if chief:
                    self._rotate_checkpoints()
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
            if mesh is not None:
                mesh_lib.unplace_network(self.net, shardings, mesh)
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

    def load_weights_from_keras_h5(self, filepath, exclude=None):
        """Load a Keras-2 h5 file written by the reference codebase (a
        pretrained YOLO branch or a whole ModelCheckpoint file). Layers merge
        by name with a shape check (Keras by_name semantics); `exclude` skips
        top-level modules (e.g. ["mask"]). The file's kernels are read into
        the flax-layout tree and go through the weight bridge, so the deconv
        follows flax's orientation like every other load. Needs h5py.
        Returns the conversion report."""
        import warnings

        from .utils import keras_h5

        if self._host_state is None:
            self._sync_host_state()
        params, stats, report = keras_h5.load_keras_h5(filepath)
        report.setdefault("shape_mismatch", [])
        current = weights.to_jax_variables(self._host_state)
        skip = set(exclude or ())
        merged = {"params": _deep_merge_by_name(current["params"], params, skip, report),
                  "batch_stats": _deep_merge_by_name(current["batch_stats"], stats, skip,
                                                     report)}
        self.load_jax_variables(merged)
        if report["skipped"] or report["shape_mismatch"]:
            warnings.warn(f"keras_h5 load from {filepath}: skipped layers {report['skipped']}, "
                          f"shape mismatches {report['shape_mismatch']}", stacklevel=2)
        return report

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
        would keep serving the stale graph; and the sharded detector, whose
        tensor-parallel copy does too."""
        self._qdet = None
        self._sharded_det = None

    # -- inference -------------------------------------------------------------

    def load_jax_variables(self, variables):
        """Load a flax variable tree of `mask_yolo_tpu.MaskYoloNet` (numpy
        leaves, e.g. `jax.device_get(model.variables)`)."""
        state = weights.from_jax_variables(variables, self.net.state_dict().keys())
        self.net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        self._host_state = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
                            for k, v in state.items()}
        self._invalidate_infer_fns()

    def quantize(self, calib_images, finetune_steps: int = 0, finetune_lr: float = 1e-5):
        """Switch detect/detect_batch/infer_yolo to the int8 path (post-training
        quantization, quant.py). calib_images: [N, H, W, 3] uint8 (divided
        by 255) or float in [0, 1], for the activation-range calibration,
        which runs on the model's device. The config's QUANT_* switches pick
        the statistics (QUANT_PER_CHANNEL_ACT, QUANT_CALIB_PCT,
        QUANT_BIAS_CORRECT) and the kernels (QUANT_DW_INT8 + QUANT_FUSED_DS:
        K1; QUANT_FUSED_MASK: K3). finetune_steps > 0 then runs the
        label-free quantization-aware fine-tuning
        (QuantizedDetector.finetune) on calib_images at finetune_lr. A later
        load_jax_variables, load_weights or train drops the int8 detector.
        With BACKBONE "resnet50_fpn" the detector is hybrid: this model's
        float network runs the trunk, the mask head runs int8."""
        calib = calib_images
        if not torch.is_tensor(calib):
            calib = torch.from_numpy(np.ascontiguousarray(calib))
        calib = calib.to(self.device)
        if not calib.is_floating_point():
            calib = calib.float() / 255.0
        if self._host_state is None:
            self._sync_host_state()
        self.net.eval()
        qdet = QuantizedDetector.from_variables(
            weights.to_jax_variables(self._host_state), self.config, calib,
            device=self.device, net=self.net)
        if finetune_steps:
            qdet.finetune(calib, steps=finetune_steps, lr=finetune_lr)
        self._qdet = qdet
        return qdet

    def export_model(self, path, batch_size=None, input_dtype="uint8", platforms=None):
        """Export the detect pipeline, weights inside, to a `torch.export`
        artifact at `path`, which `export.ExportedDetector.load(path)` serves
        with no model code. batch_size=None exports a symbolic batch
        dimension (one artifact, any B). After quantize() the active int8
        pipeline is exported, as detect/detect_batch then serve it. The
        program is traced on the model's device; `platforms` lists the device
        types it may be loaded onto. Returns the artifact's header dict (see
        export.py for the format)."""
        if self._qdet is not None:
            fused = bool(getattr(self.config, "QUANT_FUSED_MASK", False))
            detect = self._qdet.detect_fn(fused_mask=fused)
            h, w, c = self.config.IMAGE_SHAPE
            with torch.no_grad():   # pack the int8 weights outside the trace
                detect(torch.zeros((1, h, w, c), dtype=torch.uint8, device=self.device))
            program, header = export_lib.export_detect_fn(
                detect, self.config, batch_size=batch_size, input_dtype=input_dtype,
                platforms=platforms, compute_path="int8", device=self.device,
                net=self._qdet.float_net)
        else:
            self.net.eval()
            program, header = export_lib.export_detect(
                self.net, self.config, batch_size=batch_size, input_dtype=input_dtype,
                platforms=platforms)
        export_lib.save_exported(program, header, path)
        return header

    def _images(self, images):
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if list(images.shape[1:]) != list(self.config.IMAGE_SHAPE):
            raise ValueError(f"expected images [B, {self.config.IMAGE_SHAPE}], "
                             f"got {list(images.shape)}")
        return images.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def detect_batch(self, images, weights_dir=None, mesh=None):
        """[B, H, W, 3] uint8, or float in [0, 1] (numpy or tensor) → the
        fixed-shape dict of tensors on the model's device (see
        pipelines.detect_outputs); the int8 path after quantize().
        weights_dir: a checkpoint to load first.

        mesh: a parallel.mesh.Mesh, or True for the model's own (`mesh`):
        `images` is this rank's local batch, detected by a
        parallel.inference.ShardedDetector (or, after quantize(), by the
        int8 detector), and the result is this rank's."""
        if weights_dir is not None:
            self.load_weights(weights_dir)
        if mesh is not None and mesh is not False:
            mesh = self.mesh if mesh is True else mesh
            if self._qdet is not None:
                return self._qdet.detect_outputs(self._images(images), mesh=mesh)
            if self._sharded_det is None or self._sharded_det.mesh is not mesh:
                self._sharded_det = ShardedDetector(self.net, self.config, mesh=mesh)
            return self._sharded_det(self._images(images))
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

    def _one_image(self, image, weights_dir):
        image = np.asarray(image)
        if image.dtype != np.uint8:
            raise ValueError(f"expected a uint8 image, got {image.dtype}")
        if weights_dir is not None:
            self.load_weights(weights_dir)
        return image[None]

    def infer_yolo(self, image, weights_dir=None, save_path="./img_results/",
                   display=True):
        """Detection-only inference on one uint8 [H, W, 3] image: a list of
        `BoundBox` (utils/host_ops.py: .xmin/.get_label()/.get_score() and
        dict access), normalized coordinates. After quantize() this serves
        the int8 trunk, like detect. display=True (the default, as in the
        JAX package) draws the boxes into save_path/InferYOLO-<time>.png,
        which needs matplotlib."""
        out = {k: v.cpu().numpy() for k, v in
               self._infer_yolo_batch(self._one_image(image, weights_dir)).items()}
        boxes = []
        for i in np.where(out["valid"][0])[0]:
            x1, y1, x2, y2 = out["boxes"][0, i]
            boxes.append(BoundBox(xmin=float(x1), ymin=float(y1), xmax=float(x2),
                                  ymax=float(y2), score=float(out["scores"][0, i]),
                                  label=int(out["classes"][0, i])))
        if display:
            from .utils import visualize

            os.makedirs(save_path, exist_ok=True)
            now = datetime.datetime.now().strftime("%b-%d-%H-%M")
            visualize.draw_boxes_mpl(image, boxes, self.config.LABELS,
                                     save_file=os.path.join(save_path, f"InferYOLO-{now}.png"))
        return boxes

    def detect(self, image, weights_dir=None, save_path="./img_results/",
               cs_threshold=0.35, display=True):
        """One uint8 [H, W, 3] image → [{bboxes, class_ids,
        confidence_scores, full_masks [H, W, N]}] as numpy arrays (the JAX
        package's signature). display=True (the default) draws the instances
        into save_path/InferMaskYOLO-<name>-<time>.png, which needs
        matplotlib."""
        if self.mode != "inference":
            raise ValueError("detect needs a model in 'inference' mode")
        out = {k: v.cpu().numpy() for k, v in
               self.detect_batch(self._one_image(image, weights_dir)).items()}
        idx = np.where(out["valid"][0] & (out["scores"][0] >= cs_threshold))[0]
        results = [{
            "bboxes": out["boxes"][0][idx],
            "class_ids": out["classes"][0][idx],
            "confidence_scores": out["scores"][0][idx],
            "full_masks": np.transpose(out["masks"][0][idx], (1, 2, 0)),
        }]
        if display:
            from .utils import visualize

            os.makedirs(save_path, exist_ok=True)
            now = datetime.datetime.now().strftime("%b-%d-%H-%M")
            name = self.config.NAME or "MaskYOLO"
            r = results[0]
            visualize.display_instances(
                image, r["bboxes"], r["full_masks"], r["class_ids"], self.config.LABELS,
                r["confidence_scores"],
                save_path=os.path.join(save_path, f"InferMaskYOLO-{name}-{now}.png"))
        return results

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
