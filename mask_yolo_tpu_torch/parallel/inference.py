"""Batched detection on a mesh — port of `mask_yolo_tpu/parallel/inference.py`.

`pipelines.detect_outputs` treats each image on its own (decode, NMS, top-K,
the mask branch and the paste run per image), so data parallelism needs no
collective: each rank detects its local batch, as the JAX package's
`shard_map` branch runs each device's slice. With MODEL_PARALLEL > 1 the
detector holds a copy of the network whose wide convs keep their rank's
output channels and gather them over the model group (parallel/mesh.py,
models/layers.py), as the JAX package's GSPMD branch shards them; the ranks
of one model group then pass the same local batch.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import pipelines
from .mesh import build_mesh, place_network


class ShardedDetector:
    """Batched image → boxes + masks on a (data, model) mesh.

    Usage (in every process of the job):
        det = ShardedDetector(net, config)          # mesh built from config
        out = det(local_images)    # [b, H, W, 3] uint8 or float in [0, 1]
        host = det.local_results(out)               # this rank's, numpy
    """

    def __init__(self, net, config, mesh=None):
        if mesh is None:
            mesh = build_mesh(config)
        self.mesh = mesh
        self.config = config
        if mesh.mp > 1:
            net = copy.deepcopy(net)
            place_network(net, mesh)
        self.net = net.eval()

    @torch.inference_mode()
    def __call__(self, images):
        """This rank's local batch (numpy or tensor; uint8 stays uint8 and is
        normalized on the device) → the detect dict of tensors."""
        device = next(self.net.parameters()).device
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return pipelines.detect_outputs(self.net, images.to(device), self.config)

    @staticmethod
    def local_results(out):
        """This rank's batch slice of `out`, as host numpy."""
        return {k: v.cpu().numpy() for k, v in out.items()}
