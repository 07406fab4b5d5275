"""The (data, model) mesh over ranks and the sharding policy — port of
`mask_yolo_tpu/parallel/mesh.py`.

The JAX package builds a `Mesh` over its devices and lets GSPMD insert the
collectives. The port runs one process, and one device, per rank, so its mesh
is a grid of ranks, rank = data_index · mp + model_index, with one process
group per row and per column:

  'data'   the ranks that share a model index: the batch is split over them,
           gradients are summed over them, and so are BatchNorm's batch
           statistics and the losses' normalizers;
  'model'  the ranks that share a data index: tensor parallelism. Every conv
           whose output channels number at least TP_MIN_CHANNELS and divide
           by mp is held as its rank's O/mp channels (`param_shardings`),
           with its BatchNorm's parameters and statistics and their Adam
           moments; its output is gathered over the group (models/layers.py).

A `Mesh` is made in every process of the job, in the same order (its groups
are made collectively). Without a process group it is a mesh of one rank,
whose groups are None and whose collectives do nothing, as the JAX package's
mesh over one device runs without any; so is the group of an axis of size 1
(the data group under pure TP, the model group under pure DP).

It is not a `torch.distributed.DeviceMesh`, which needs a process group and a
device type: the port's mesh also exists in a single process
(`detect_batch(mesh=True)`), and its two groups are all the paths use.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.layers import BatchNorm, ConvTranspose2d, SameConv2d, TensorParallel
from . import collectives

# Channel widths below this stay replicated: sharding a 64-wide conv buys
# nothing and costs a collective per layer.
TP_MIN_CHANNELS = 256


class Mesh:
    """A dp × mp grid of ranks with axes ("data", "model")."""

    axis_names = ("data", "model")

    def __init__(self, dp: int, mp: int):
        self.dp, self.mp = int(dp), int(mp)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.data_group = self.model_group = None
        if dist.is_initialized():
            # every rank makes every group, in one order; an axis of size 1
            # gets none (a sum over one rank is the identity)
            for j in range(self.mp if self.dp > 1 else 0):
                group = dist.new_group([d * self.mp + j for d in range(self.dp)])
                if self.rank % self.mp == j:
                    self.data_group = group
            for d in range(self.dp if self.mp > 1 else 0):
                group = dist.new_group([d * self.mp + j for j in range(self.mp)])
                if self.rank // self.mp == d:
                    self.model_group = group
        if self.rank >= self.dp * self.mp:
            raise ValueError(f"rank {self.rank} lies outside the {self.dp}x{self.mp} mesh")

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.mp}

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    def __repr__(self):
        return f"Mesh(data={self.dp}, model={self.mp}, rank={self.rank})"


def build_mesh(config=None, batch_size: int = 0, world_size: int | None = None) -> Mesh:
    """Build a (data, model) mesh over the job's ranks. DATA_PARALLEL=0 means
    'all ranks / MODEL_PARALLEL'.

    batch_size > 0 (the global batch): when DATA_PARALLEL is auto, shrink the
    data axis to the largest size dividing the batch. An explicit
    DATA_PARALLEL is honoured as given (dp · mp may not exceed the ranks)."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    mp = int(getattr(config, "MODEL_PARALLEL", 1) or 1) if config is not None else 1
    dp = int(getattr(config, "DATA_PARALLEL", 0) or 0) if config is not None else 0
    if dp == 0:
        dp = max(world_size // mp, 1)
        if batch_size > 0:
            while dp > 1 and batch_size % dp != 0:
                dp -= 1
    if dp * mp > world_size:
        raise ValueError(f"mesh {dp}x{mp} > {world_size} ranks")
    return Mesh(dp, mp)


def _out_dim(module) -> int:
    """The output-channel dim of a module's weight: 1 for a transposed conv
    ([I, O, kh, kw]), 0 for a conv ([O, I/g, kh, kw])."""
    return 1 if isinstance(module, torch.nn.ConvTranspose2d) else 0


def param_shardings(net, mesh: Mesh) -> dict:
    """{state_dict key: sharded dim or None} for tensor-parallel placement.

    The JAX package's rule on the output-channel dim: a conv kernel, a
    depthwise kernel, a bias and a BatchNorm's scale, shift and statistics
    are sharded over 'model' on their output-channel dim when it holds at
    least TP_MIN_CHANNELS channels and divides by mp; everything else, and
    everything when mp = 1, is replicated. Adam's moments follow their
    parameters (`gather_tree`, `shard_tree`)."""
    mp = mesh.mp
    out = {}
    for prefix, module in net.named_modules():
        for name, t in list(module.named_parameters(recurse=False)) + list(
                module.named_buffers(recurse=False)):
            dim = _out_dim(module) if name == "weight" else 0
            wide = (mp > 1 and t.dim() > dim and t.shape[dim] >= TP_MIN_CHANNELS
                    and t.shape[dim] % mp == 0 and name != "num_batches_tracked")
            out[f"{prefix}.{name}" if prefix else name] = dim if wide else None
    return out


def _block(t, dim, mesh: Mesh):
    n = t.shape[dim] // mesh.mp
    return t.narrow(dim, mesh.model_index * n, n)


def shard_tree(tree: dict, shardings: dict, mesh: Mesh) -> dict:
    """{key: full tensor} → this rank's slices (keys missing from
    `shardings` stay whole)."""
    return {k: _block(v, shardings[k], mesh).clone() if shardings.get(k) is not None else v
            for k, v in tree.items()}


def gather_tree(tree: dict, shardings: dict, mesh: Mesh) -> dict:
    """{key: this rank's slice} → the whole tensors, on every rank of the
    model group (a collective: every rank calls it)."""
    return {k: collectives.gather(v, mesh.model_group, shardings[k])
            if shardings.get(k) is not None else v for k, v in tree.items()}


def _replace_sharded(modules: dict, shardings: dict, fn):
    """Each sharded parameter or buffer `t` of `modules` becomes fn(t, dim),
    a parameter staying a parameter (with its requires_grad)."""
    with torch.no_grad():
        for key, dim in shardings.items():
            if dim is None:
                continue
            prefix, name = key.rsplit(".", 1)
            module = modules[prefix]
            value = fn(getattr(module, name).detach(), dim)
            if name in module._parameters:
                module._parameters[name] = torch.nn.Parameter(
                    value, requires_grad=module._parameters[name].requires_grad)
            else:
                module._buffers[name] = value


def place_network(net, mesh: Mesh):
    """Put a network (full weights, on this rank's device) on the mesh, in
    place: every BatchNorm sums its batch statistics over the data group,
    and, when the mesh has a real 'model' axis, every wide conv keeps its
    rank's output channels, with its BatchNorm, and gathers its output over
    the model group. Returns the shardings (param_shardings)."""
    shardings = param_shardings(net, mesh)
    modules = dict(net.named_modules())
    _replace_sharded(modules, shardings, lambda t, dim: _block(t, dim, mesh).clone())
    for prefix, module in modules.items():
        if isinstance(module, BatchNorm):
            module.data_group = mesh.data_group
        elif isinstance(module, (SameConv2d, ConvTranspose2d)) and \
                shardings.get(f"{prefix}.weight") is not None:
            channels = module.weight.shape[_out_dim(module)] * mesh.mp
            module.tp = TensorParallel(mesh.model_group, mesh.model_index, mesh.mp, channels)
            if module.groups > 1:   # depthwise: one group per channel
                module.groups //= mesh.mp
    return shardings


def unplace_network(net, shardings: dict, mesh: Mesh):
    """place_network undone: the whole weights gathered back (a collective;
    conv kernels channels_last again, as the model holds them) and the
    modules off the mesh."""
    def whole(t, dim):
        t = collectives.gather(t, mesh.model_group, dim)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

    modules = dict(net.named_modules())
    _replace_sharded(modules, shardings, whole)
    for module in modules.values():
        if isinstance(module, BatchNorm):
            module.data_group = None
        elif getattr(module, "tp", None) is not None:
            if module.groups > 1:
                module.groups *= mesh.mp
            module.tp = None


def batch_slice(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of n (n divisible by the data axis)."""
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not split over {mesh.dp} data ranks")
    per = n // mesh.dp
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def gather_batch(out: dict, mesh: Mesh) -> dict:
    """{key: this rank's [n, ...] rows} → the global batch's [dp·n, ...]
    rows, in data-index order, on every rank (a collective)."""
    return {k: collectives.gather(v, mesh.data_group)
            for k, v in out.items()}
