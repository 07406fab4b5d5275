"""Joining a multi-process job, and each process's share of the data — port
of `mask_yolo_tpu/parallel/distributed.py`.

The port runs one process per device. The recipe, as in the JAX package:

 1. every process calls `initialize()` (driven by the environment; a no-op
    in a single process), which joins a `torch.distributed` process group:
    NCCL on the card, gloo for the CPU or for ranks that share one card
    (NCCL refuses two ranks on one device);
 2. every process builds the same mesh (`mesh.build_mesh`), in the same
    order;
 3. each process loads only its slice of the data (`local_image_ids`, by
    its data index) and keeps it: BATCH_SIZE is per process, the JAX
    package's multi-host contract (`global_batch_from_local`);
 4. the train step (train/trainer.py) sums the gradients, the losses'
    normalizers and BatchNorm's statistics over the data group.

Checkpoints: the whole tree is written by the chief alone (`is_chief`).
Tested with 2 and 4 gloo processes on the CPU
(tests/test_torch_parallel.py).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

_ENV_PREFIX = "MYOLO"
TIMEOUT_S = 300.0


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device="cuda", backend=None, timeout_s: float = TIMEOUT_S) -> tuple[int, int]:
    """Join the job. The arguments default to MYOLO_COORDINATOR (host:port),
    MYOLO_NUM_PROCESSES and MYOLO_PROCESS_ID, else to the standard
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK (as `torchrun` sets them);
    with neither, this is a single-process no-op.

    device: where the ranks compute, "cuda" unless the caller asks for the
    CPU; it picks the backend (NCCL for "cuda", gloo for "cpu") unless
    `backend` names one, as gloo for ranks that share one card. On the
    card each process takes device LOCAL_RANK (default: its rank modulo the
    devices). timeout_s bounds every collective, so a rank that died fails
    the others instead of hanging them. Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    coordinator_address = coordinator_address or env.get(f"{_ENV_PREFIX}_COORDINATOR")
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return 0, 1
    if num_processes is None:
        num_processes = int(env.get(f"{_ENV_PREFIX}_NUM_PROCESSES", env.get("WORLD_SIZE", 1)))
    if process_id is None:
        process_id = int(env.get(f"{_ENV_PREFIX}_PROCESS_ID", env.get("RANK", 0)))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def shutdown():
    """Leave the job (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_chief() -> bool:
    """True on the process that writes checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_image_ids(image_ids, process_index: int | None = None,
                    process_count: int | None = None) -> np.ndarray:
    """This process's slice of a dataset's image ids. A strided split, so
    class balance survives ordered datasets; every process gets the same
    count (the trailing remainder is dropped, keeping global batches full).
    On a mesh pass the data index and the data-axis size, so that the ranks
    of one model group load the same slice."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    ids = np.asarray(image_ids)
    per = len(ids) // process_count
    if per == 0:
        raise ValueError(f"{len(ids)} images cannot feed {process_count} processes")
    return ids[process_index::process_count][:per]


def global_batch_from_local(batch: dict, mesh=None) -> dict:
    """The global batch of a step, as this process holds it: its local
    batch, unchanged.

    The JAX package assembles one global array from the processes' local
    shards (`jax.make_array_from_process_local_data`), because its step is
    one program over every device. The port runs one device per process,
    and each process's step reads its own local batch; what makes the step
    the global batch's are the sums over the data group (train/trainer.py).
    This is the JAX package's multi-host contract, where BATCH_SIZE is per
    process (`mask_yolo_tpu/model.py:146-147`)."""
    del mesh
    return batch
