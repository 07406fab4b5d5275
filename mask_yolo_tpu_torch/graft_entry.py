"""The graft entry points of the port — the counterpart of the root
`__graft_entry__.py` (which imports the JAX package), function by function.

entry(device=None)         -> (fn, example_args): the flagship detect at 224²
                              (ShapesConfig at full width, bf16, batch 8) as
                              a function of the weights and the images,
                              traceable by torch.export with the kernels as
                              their torch.library ops.
dryrun_multichip(n_devices, device=None, backend=None, variables=None)
                           -> one sharded training step and a sharded detect
                              on an n-rank (data, model) mesh at tiny shapes,
                              each rank a process over torch.distributed.

    python -m mask_yolo_tpu_torch.graft_entry   # on the card: entry() eagerly,
                                                # then dryrun_multichip over
                                                # every card
    python -m mask_yolo_tpu_torch.graft_entry --device cpu

Every function runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import multiprocessing
import queue as queue_lib
import socket
import traceback

import numpy as np
import torch

from . import MaskYOLO, pipelines
from .config import Config
from .data.shapes import ShapesConfig
from .ops import ds_block, mask_fused, roi_crop
from .parallel import distributed
from .parallel import mesh as mesh_lib
from .parallel.inference import ShardedDetector
from .train import state as state_lib
from .train import trainer as trainer_lib

ENTRY_BATCH = 8
DRYRUN_LR = 1e-3
RANK_TIMEOUT_S = 300.0    # a rank of dryrun_multichip that runs longer is killed
LAUNCH_COUNTERS = {"crop_rois": roi_crop.crop_rois,
                   "crop_rois_backward": roi_crop.crop_rois_backward,
                   "fused_ds_block": ds_block.fused_ds_block,
                   "fused_mask_branch": mask_fused.fused_mask_branch}


def _device(device):
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return device


class _Detect(torch.nn.Module):
    """images → the detect dict of `net` (a submodule, so that
    torch.func.functional_call swaps in the weights it is handed)."""

    def __init__(self, net, config):
        super().__init__()
        self.net = net
        self.config = config

    def forward(self, images):
        return pipelines.detect_outputs(self.net, images, self.config)


def _flagship(batch_size: int = ENTRY_BATCH, device=None):
    """(config, model): ShapesConfig at full width in bf16, the port's seeded
    weights."""
    cfg = type("BenchConfig", (ShapesConfig,), {"BATCH_SIZE": batch_size,
                                                "COMPUTE_DTYPE": "bfloat16"})()
    return cfg, MaskYOLO("inference", cfg, seed=0, device=_device(device))


def entry(device=None):
    """Returns (fn, example_args): fn(state, images) is the full inference
    step, image → boxes + masks (`pipelines.detect_outputs`), on the weights
    `state` (a state_dict of the network); example_args are the seeded
    network's state (detached tensors: no autograd graph is built) and 8
    zero images on `device` (the card unless the caller asks for the
    CPU)."""
    cfg, model = _flagship(ENTRY_BATCH, device)
    detect = _Detect(model.net.eval(), cfg)

    def forward(state, images):
        return torch.func.functional_call(detect, {f"net.{k}": v for k, v in state.items()},
                                          (images,))

    example_images = torch.zeros((ENTRY_BATCH, *cfg.IMAGE_SHAPE), dtype=torch.float32,
                                 device=model.device)
    return forward, (dict(model.net.state_dict()), example_images)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, state, images):
        return self.fn(state, images)


def export_entry(fn, example_args):
    """The `torch.export` program of entry()'s fn at the example arguments'
    shapes: the weights are inputs, the kernels their torch.library ops."""
    return torch.export.export(_Fn(fn), tuple(example_args))


# ---- dryrun_multichip ---------------------------------------------------------


def dryrun_config(n_devices: int):
    """The JAX dryrun's TinyConfig (`__graft_entry__.py:76-96`), field for
    field: 64² images, a 2×2 grid, TRAIN_BN, and a model axis of 2 when the
    rank count is even and > 1."""
    mp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return type("TinyConfig", (Config,), {
        "NAME": "dryrun", "LABELS": ["background", "a", "b"], "NUM_CLASSES": 3,
        "IMAGE_SHAPE": [64, 64, 3], "IMAGE_MIN_DIM": 64, "IMAGE_MAX_DIM": 64,
        "GRID_H": 2, "GRID_W": 2, "N_BOX": 2, "ANCHORS": [0.6, 0.7, 1.2, 1.1],
        "TRUE_BOX_BUFFER": 4, "MAX_GT_INSTANCES": 4, "TRAIN_ROIS_PER_IMAGE": 8,
        "MASK_POOL_SIZE": 4, "MASK_SHAPE": [8, 8], "TOP_FEATURE_MAP_DEPTH": 16,
        "DETECTION_MAX_INSTANCES": 4, "TRAIN_BN": True, "MODEL_PARALLEL": mp,
        "DATA_PARALLEL": max(n_devices // mp, 1)})()


def dryrun_batch(cfg, batch_size: int):
    """The JAX dryrun's hand-written batch (`__graft_entry__.py:134-153`):
    seeded noise images, one object a image."""
    rng = np.random.RandomState(0)
    g, h, w = cfg.MAX_GT_INSTANCES, 64, 64
    batch = {
        "image": rng.rand(batch_size, h, w, 3).astype(np.float32),
        "yolo_target": np.zeros((batch_size, cfg.GRID_H, cfg.GRID_W, cfg.N_BOX,
                                 5 + cfg.NUM_CLASSES), np.float32),
        "true_boxes": np.zeros((batch_size, 1, 1, 1, cfg.TRUE_BOX_BUFFER, 4), np.float32),
        "gt_class_ids": np.zeros((batch_size, g), np.int32),
        "gt_boxes": np.zeros((batch_size, g, 4), np.float32),
        "gt_masks": np.zeros((batch_size, h, w, g), bool),
    }
    for b in range(batch_size):
        batch["yolo_target"][b, 1, 0, 0] = [0.5, 1.5, 0.8, 0.8, 1.0] + [0.0, 1.0, 0.0]
        batch["true_boxes"][b, 0, 0, 0, 0] = [0.5, 1.5, 0.8, 0.8]
        batch["gt_class_ids"][b, 0] = 1
        batch["gt_boxes"][b, 0] = [4, 36, 28, 60]
        batch["gt_masks"][b, 40:56, 8:24, 0] = True
    return batch


def _launches():
    return {name: wrapper.launches for name, wrapper in LAUNCH_COUNTERS.items()}


def _dryrun_rank(rank, n, port, device, backend, variables, tf32):
    """One rank of dryrun_multichip: the sharded train step, then the sharded
    detect. Returns this rank's result."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(2)
    distributed.initialize(f"localhost:{port}", n, rank, device=device.type, backend=backend)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        cfg = dryrun_config(n)
        mesh = mesh_lib.build_mesh(cfg)
        batch_size = max(mesh.dp, 2 * mesh.dp)   # divisible by the data axis
        model = MaskYOLO("training", cfg, seed=0, device=device)
        if variables is not None:
            model.load_jax_variables(variables)
        initial = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
        for wrapper in LAUNCH_COUNTERS.values():
            wrapper.launches = 0
        shardings = mesh_lib.place_network(model.net, mesh)
        tx = state_lib.make_optimizer(DRYRUN_LR, cfg, dict(model.net.named_parameters()))
        tx.shard(shardings, mesh.model_group)
        step = trainer_lib.make_train_step(cfg, tx, "training", mesh=mesh)
        state = state_lib.create_train_state(model.net, tx)
        batch = dryrun_batch(cfg, batch_size)
        rows = mesh_lib.batch_slice(batch_size, mesh)
        state, metrics = step(state, {k: torch.from_numpy(v[rows]).to(device)
                                      for k, v in batch.items()})
        loss = float(metrics["loss"])
        if not np.isfinite(loss) or int(state.step) != 1:
            raise AssertionError(f"loss {loss} at step {int(state.step)}, not finite at step 1")
        train_launches = _launches()

        # the inference path on the same mesh, from the weights before the step
        infer = MaskYOLO("inference", cfg, device=device)
        infer.net.load_state_dict(initial)
        det = ShardedDetector(infer.net, cfg, mesh=mesh)
        out = mesh_lib.gather_batch(det(batch["image"][rows]), mesh)
        detect_launches = {k: v - train_launches[k] for k, v in _launches().items()}
        shape = list(out["boxes"].shape)
        if shape[0] != batch_size or not bool(torch.isfinite(out["scores"]).all()):
            raise AssertionError(f"detect gave boxes {shape} for a batch of {batch_size}")
        return {"n_devices": n, "mesh": [mesh.dp, mesh.mp], "axes": list(mesh.axis_names),
                "loss": loss, "step": int(state.step), "detect": shape, "backend": backend,
                "device": str(device), "launches": {"train": train_launches,
                                                    "detect": detect_launches}}
    finally:
        distributed.shutdown()


def _rank_main(rank, n, port, device, backend, variables, tf32, results):
    try:
        results.put((rank, "ok", _dryrun_rank(rank, n, port, device, backend, variables, tf32)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None, backend=None, variables=None) -> dict:
    """Run one sharded training step and a sharded detect on an n-rank mesh
    and print the JAX dryrun's line (`mesh=… loss=… step=… detect=… OK`).

    Each rank is a process over torch.distributed, started here and stopped
    before this returns: NCCL on the card (one card a rank), gloo on the CPU
    (device="cpu") or for ranks that share one card (backend="gloo").
    variables: a flax variable tree of the JAX package's network (numpy
    leaves), loaded into every rank in place of the port's seeded weights.
    The ranks compute with the caller's TF32 settings (cuDNN and matmul),
    which a new process would otherwise reset to torch's defaults.
    Returns rank 0's result: the loss, the step, the mesh, the detect's
    boxes shape, and rank 0's kernel launches in the step and in the detect
    ("launches")."""
    device = _device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and backend == "nccl" and n_devices > torch.cuda.device_count():
        raise ValueError(f"need {n_devices} devices, have {torch.cuda.device_count()} "
                         f"(ranks that share a card need backend='gloo')")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, n_devices, port, str(device), backend, variables, tf32,
                               results))
             for rank in range(n_devices)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        while len(got) < n_devices:
            try:
                rank, status, value = results.get(timeout=RANK_TIMEOUT_S)
            except queue_lib.Empty:
                raise TimeoutError(f"dryrun_multichip({n_devices}): ranks "
                                   f"{sorted(set(range(n_devices)) - set(got))} gave no "
                                   f"result within {RANK_TIMEOUT_S:.0f} s") from None
            if status == "error":
                raise RuntimeError(f"dryrun_multichip({n_devices}): rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    result = got[0]
    print(f"dryrun_multichip(n={n_devices}): mesh={tuple(result['mesh'])} "
          f"axes={tuple(result['axes'])} loss={result['loss']:.4f} step={result['step']} "
          f"detect={tuple(result['detect'])} OK", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="entry() eagerly, then dryrun_multichip")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = _device(ap.parse_args(argv).device)
    fn, example_args = entry(device)
    out = fn(*example_args)
    print("entry OK:", {k: tuple(v.shape) for k, v in out.items()}, flush=True)
    # every card, as the JAX function runs over every device; one rank on the CPU
    return dryrun_multichip(torch.cuda.device_count() if device.type == "cuda" else 1, device)


if __name__ == "__main__":
    main()
