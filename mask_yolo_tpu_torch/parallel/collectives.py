"""The collectives of the parallel paths: all-reduce and all-gather.

The JAX package leaves its collectives to GSPMD, which inserts them into one
program over the mesh. The port runs one process per device and calls them
itself, over `torch.distributed` process groups: NCCL, and gloo for ranks
that share one card, which NCCL refuses. Both run all_reduce and the
list-form all_gather on CUDA tensors (gloo through host copies). A gather
concatenates the ranks' blocks in group-rank order, which is the mesh index
along the group's axis. Each takes a group of None as a group of one and then
does nothing.

Gradients, for the tensor-parallel convs (models/layers.py): every rank of a
model group runs the same computation downstream of a gather, so the
gather's backward takes the rank's own slice of the gradient (a sum over the
group, as `torch.distributed.nn.functional.all_gather` takes, would be `mp`
times too large); the input of a column-parallel conv is the identity
forward and an all-reduce backward, where each rank's conv contributed its
output channels' share of the input's gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_(t, group):
    """Sum `t` over `group` in place (no autograd); returns `t`."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the gradient of each rank's input is the sum of the
    ranks' output gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(x, group):
    """Sum over `group` that carries gradients (BatchNorm's batch
    statistics over a data group)."""
    return x if group is None else _AllReduce.apply(x, group)


class _EnterGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def enter_group(x, group):
    """Identity forward; backward sums the input gradient over `group`: the
    input of a column-parallel layer, each of whose ranks computes a share
    of the output channels."""
    return x if group is None else _EnterGroup.apply(x, group)


def _all_gather(x, group, dim: int):
    """The ranks' `x` (one shape) concatenated along `dim`."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, lo):
        ctx.lo, ctx.hi = lo, lo + x.shape[1]
        # gathered as NHWC, whose storage is channels_last NCHW's
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        return _all_gather(nhwc, group, 3).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.lo:ctx.hi], None, None


def gather_channels(x, group, lo: int):
    """NCHW `x` holding channels [lo, lo + C) of the group's whole → all of
    them, gathered over `group` (channels_last memory). Backward: the own
    slice."""
    return _GatherChannels.apply(x, group, lo)


def gather(x, group, dim: int = 0):
    """A tensor split over the ranks of `group` along `dim` (group rank i
    holds the i-th block) → the whole, on every rank (no autograd). bool
    tensors go through uint8."""
    if group is None:
        return x
    kind = x.dtype
    x = x.to(torch.uint8) if kind == torch.bool else x
    return _all_gather(x.contiguous(), group, dim).to(kind)
