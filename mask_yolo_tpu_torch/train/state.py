"""Training state, the optimizer, layer freezing and checkpoints — port of
`mask_yolo_tpu/train/state.py`.

The optimizer is the optax chain that the JAX package's `make_optimizer`
builds, written out step by step (not `torch.optim.Adam` plus
`clip_grad_norm_`, whose clip adds 1e-6 to the norm):

  1. zero_nonfinite: non-finite gradient entries become 0;
  2. clip_by_global_norm(GRADIENT_CLIP_NORM) over the trainable leaves:
     g·max/‖g‖ when ‖g‖ ≥ max;
  3. Adam, b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected;
  4. times −lr, with lr = make_lr_schedule(...)(count) read at the count
     before the increment (with linear warm-up the first step's lr is 0).

Freezing follows `trainable_labels`: the regex is matched against each
parameter's flax path and its segments (`backbone/block1/conv_dw/kernel`),
not its torch key. Frozen parameters get no update and no Adam state; their
BatchNorm running statistics still move under TRAIN_BN, as in JAX, where
only parameters are frozen.

A TrainState holds the live network (parameters and BatchNorm statistics
are its tensors, updated in place), the optimizer state and the step, which
also drives the YOLO loss's warm-up. Checkpoints are `torch.save` files of
{params, batch_stats, opt_state, step, epoch} keyed by torch state_dict keys;
orbax checkpoints of the JAX package are not read.

On a mesh (parallel/mesh.py) under tensor parallelism a rank holds slices of
the wide parameters, statistics and Adam moments. Its optimizer sums the
slices' squared norms over the model group for the global-norm clip
(`Optimizer.shard`). A checkpoint holds the whole tree: every rank takes
part in gathering it and the chief alone writes it, so it resumes on one
device as on the mesh (`resume_train_state` slices it again).
"""

from __future__ import annotations

import dataclasses
import math
import re
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_lib
from ..parallel.collectives import all_reduce_
from ..weights import flax_path

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    net: torch.nn.Module
    opt_state: dict
    step: int = 0

    @property
    def params(self) -> dict:
        return dict(self.net.named_parameters())

    @property
    def batch_stats(self) -> dict:
        return {k: v for k, v in self.net.named_buffers()
                if k.endswith(("running_mean", "running_var"))}


def trainable_labels(params: dict, layer_regex: str) -> dict:
    """{torch key: True (train) / False (freeze)} by regex on the flax path:
    a parameter trains iff re.fullmatch(layer_regex, ·) hits the whole path
    or one of its segments."""
    pattern = re.compile(layer_regex)
    labels = {}
    for key, p in params.items():
        name = flax_path(key, p.dim())
        labels[key] = any(pattern.fullmatch(c) for c in [name] + name.split("/"))
    return labels


def make_lr_schedule(learning_rate: float, config, total_steps: int = 0):
    """config.LR_SCHEDULE as a function of the update count, or the bare
    float for a constant rate without warm-up: "constant" with
    LR_WARMUP_STEPS of linear warm-up from 0, or "cosine" (optax
    warmup_cosine_decay_schedule) from peak to peak·LR_FINAL_FRACTION over
    LR_TOTAL_STEPS or `total_steps`."""
    kind = str(getattr(config, "LR_SCHEDULE", "constant") or "constant")
    warmup = int(getattr(config, "LR_WARMUP_STEPS", 0) or 0)
    if kind == "constant":
        if warmup <= 0:
            return learning_rate
        return lambda count: learning_rate * min(count, warmup) / warmup
    if kind != "cosine":
        raise ValueError(f"unknown LR_SCHEDULE {kind!r} (expected 'constant' or 'cosine')")
    total_steps = int(getattr(config, "LR_TOTAL_STEPS", 0) or 0) or total_steps
    if total_steps <= 0:
        raise ValueError("LR_SCHEDULE='cosine' needs total_steps > 0 "
                         "(train() passes epochs * steps_per_epoch)")
    end = learning_rate * float(getattr(config, "LR_FINAL_FRACTION", 0.0))
    warmup = min(warmup, max(total_steps - 1, 0))
    alpha = 0.0 if learning_rate == 0.0 else end / learning_rate
    decay = total_steps - warmup

    def schedule(count):
        if count < warmup:
            return learning_rate * count / warmup
        t = min(count - warmup, decay)
        return learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


class Optimizer:
    """The chain of `make_optimizer` over the trainable parameters
    (`trainable`: {torch key: bool}). Runs on the parameters' device with
    multi-tensor (`torch._foreach_*`) passes; no host synchronization."""

    def __init__(self, learning_rate: float, config, trainable: dict, total_steps: int = 0):
        self.clip = float(getattr(config, "GRADIENT_CLIP_NORM", 0) or 0)
        self.lr = make_lr_schedule(learning_rate, config, total_steps)
        self.keys = [k for k, t in trainable.items() if t]
        self.sharded, self.model_group = None, None

    def shard(self, shardings: dict, group):
        """Tensor parallelism: the keys sharded over `group` (a model group)
        hold this rank's slices; the clip's global norm sums their squares
        over the group."""
        self.model_group = group
        self.sharded = [shardings.get(k) is not None for k in self.keys]

    def init(self, params: dict) -> dict:
        return {"count": 0, "schedule": callable(self.lr),
                "mu": {k: torch.zeros_like(params[k]) for k in self.keys},
                "nu": {k: torch.zeros_like(params[k]) for k in self.keys}}

    def same_structure(self, opt_state: dict, params: dict) -> bool:
        """Whether a (restored) optimizer state fits this optimizer: the
        same trainable leaves and shapes, and a schedule exactly when this
        one has one (optax keeps a schedule count only then)."""
        mu = opt_state.get("mu", {})
        return (opt_state.get("schedule") == callable(self.lr)
                and set(mu) == set(self.keys)
                and all(mu[k].shape == params[k].shape for k in self.keys))

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, opt_state: dict):
        """One update in place: params[k] += −lr·adam(clip(zero_nonfinite(g)))
        for each trainable k; grads[k] None counts as zero."""
        if not self.keys:
            return
        p = [params[k] for k in self.keys]
        g = [torch.zeros_like(params[k]) if grads.get(k) is None
             else torch.nan_to_num(grads[k], nan=0.0, posinf=0.0, neginf=0.0)
             for k in self.keys]
        if self.clip > 0:
            norms = torch.stack(torch._foreach_norm(g))
            if self.model_group is not None and any(self.sharded):
                squares = norms * norms
                sliced = torch.tensor(self.sharded, device=norms.device)
                norm = torch.sqrt(squares[~sliced].sum()
                                  + all_reduce_(squares[sliced].sum(), self.model_group))
            else:
                norm = torch.linalg.vector_norm(norms)
            keep = norm < self.clip
            one = torch.ones_like(norm)
            # (g / ‖g‖)·max when clipping, (g / 1)·1 = g otherwise
            g = torch._foreach_div(g, torch.where(keep, one, norm))
            torch._foreach_mul_(g, torch.where(keep, one, torch.full_like(norm, self.clip)))
        mu = [opt_state["mu"][k] for k in self.keys]
        nu = [opt_state["nu"][k] for k in self.keys]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - B1))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2))
        count = opt_state["count"]
        lr = self.lr(count) if callable(self.lr) else self.lr
        opt_state["count"] = count + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count + 1))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count + 1))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)


def make_optimizer(learning_rate: float, config, params: dict, layer_regex: str = ".*",
                   frozen_prefixes: tuple = (), total_steps: int = 0) -> Optimizer:
    """The optimizer over `params` ({torch key: tensor}): parameters whose
    flax path misses `layer_regex`, or whose top-level module is in
    `frozen_prefixes` (yolo_trainable=False), are frozen."""
    labels = trainable_labels(params, layer_regex)
    labels = {k: t and k.split(".")[0] not in frozen_prefixes for k, t in labels.items()}
    return Optimizer(learning_rate, config, labels, total_steps)


def create_train_state(net, tx: Optimizer) -> TrainState:
    return TrainState(net=net, opt_state=tx.init(dict(net.named_parameters())), step=0)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def save_checkpoint(path: str, state: TrainState, epoch: int = 0, mesh=None,
                    shardings=None):
    """Save params, BatchNorm statistics, optimizer moments, step and epoch,
    so that a run resumes exactly. On a mesh every rank calls it: the whole
    tree is gathered (slices of `shardings` over the model group) and the
    chief (rank 0) alone writes it."""
    params, stats, opt_state = state.params, state.batch_stats, state.opt_state
    if mesh is not None and shardings:
        params = mesh_lib.gather_tree({k: v.detach() for k, v in params.items()},
                                      shardings, mesh)
        stats = mesh_lib.gather_tree(stats, shardings, mesh)
        opt_state = {**opt_state, **{m: mesh_lib.gather_tree(opt_state[m], shardings, mesh)
                                     for m in ("mu", "nu") if m in opt_state}}
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    torch.save({"params": _host(params), "batch_stats": _host(stats),
                "opt_state": _host(opt_state), "step": int(state.step),
                "epoch": int(epoch)}, path)


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_into(net, params: dict, batch_stats: dict):
    """Copy checkpoint tensors into the network's parameters and buffers."""
    live = dict(net.named_parameters())
    live.update(net.named_buffers())
    with torch.no_grad():
        for key, value in {**params, **batch_stats}.items():
            if key not in live or live[key].shape != value.shape:
                raise KeyError(f"checkpoint leaf {key!r} {tuple(value.shape)} does not fit "
                               f"the network")
            live[key].copy_(value)


def resume_train_state(path: str, fresh_state: TrainState, tx: Optimizer, mesh=None,
                       shardings=None):
    """Restore a checkpoint of `save_checkpoint` into `fresh_state`'s network
    and return (state, epoch). On a mesh with tensor parallelism, pass its
    `shardings`: the whole tree is sliced to this rank's share. If the
    checkpoint's optimizer state does not fit `tx` (another LR_SCHEDULE
    kind, other frozen layers), the moments are reset to the fresh ones with
    a warning; params, BatchNorm statistics, step and epoch still restore."""
    ckpt = load_checkpoint(path)
    opt_state = ckpt.get("opt_state") or {}
    if mesh is not None and shardings:
        ckpt["params"] = mesh_lib.shard_tree(ckpt["params"], shardings, mesh)
        ckpt["batch_stats"] = mesh_lib.shard_tree(ckpt.get("batch_stats") or {}, shardings,
                                                  mesh)
        opt_state = {**opt_state, **{m: mesh_lib.shard_tree(opt_state[m], shardings, mesh)
                                     for m in ("mu", "nu") if m in opt_state}}
    load_into(fresh_state.net, ckpt["params"], ckpt.get("batch_stats") or {})
    params = fresh_state.params
    if tx.same_structure(opt_state, params):
        dev = {k: params[k].device for k in tx.keys}
        opt_state = {"count": int(opt_state["count"]), "schedule": opt_state["schedule"],
                     "mu": {k: opt_state["mu"][k].to(dev[k]) for k in tx.keys},
                     "nu": {k: opt_state["nu"][k].to(dev[k]) for k in tx.keys}}
    else:
        warnings.warn(
            f"checkpoint {path}: optimizer state structure does not match the current "
            "optimizer (different LR_SCHEDULE / freezing?) — optimizer moments RESET, "
            "params/BN/epoch restored", stacklevel=2)
        opt_state = fresh_state.opt_state
    return TrainState(net=fresh_state.net, opt_state=opt_state,
                      step=int(ckpt["step"])), int(ckpt["epoch"])


def merge_params(current: dict, loaded: dict, by_name: bool = False, exclude=None) -> dict:
    """Merge loaded {torch key: tensor} into current by top-level module name.

    by_name=False: full replacement. by_name=True: replace only the modules
    present in both; `exclude` lists module names to skip."""
    exclude = set(exclude or [])
    if not by_name and not exclude:
        return dict(loaded)
    top = lambda key: key.split(".")[0]   # noqa: E731
    have = {top(k) for k in current}
    take = {top(k) for k in loaded} - exclude
    if by_name:
        take &= have
    merged = {k: v for k, v in current.items() if top(k) not in take}
    merged.update({k: v for k, v in loaded.items() if top(k) in take})
    return merged
