"""Weight bridge: a flax variable tree of `mask_yolo_tpu` → a torch state_dict.

The port's submodules carry the flax module names, so a flax leaf
`<collection>/<a>/<b>/.../<leaf>` becomes the torch key `a.b....<name>`:

    params/.../kernel       → weight   conv HWIO [kh, kw, I, O] → OIHW;
                                       a depthwise [3, 3, 1, C] → [C, 1, 3, 3]
                                       is the same transpose
    params/mask_deconv/kernel → weight flax ConvTranspose [2, 2, I, O]:
                                       flipped in both spatial axes, then
                                       → [I, O, 2, 2] for F.conv_transpose2d
    params/.../bias         → bias
    params/.../scale        → weight   (BatchNorm)
    batch_stats/.../mean    → running_mean
    batch_stats/.../var     → running_var
                            + num_batches_tracked = 0 for each BatchNorm

Why the flip: flax's ConvTranspose computes
y[2i+di, 2j+dj, o] = Σ_c x[i, j, c]·W[1-di, 1-dj, c, o], while torch's
conv_transpose2d uses W[c, o, di, dj]. The unflipped mapping is off by
O(1) on non-degenerate activations.

`to_jax_variables` is the exact inverse (the int8 path folds the weights
from a flax-layout f32 host copy, `quant.build_layer_graph`), and
`from_jax_graph` carries a calibrated, quantized layer graph of the JAX
package's `quant` across field by field.

Only numpy is needed here; the arrays are host copies
(`jax.device_get(variables)` on the JAX side).
"""

from __future__ import annotations

import numpy as np

_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def convert_kernel(module: str, kernel: np.ndarray) -> np.ndarray:
    """A flax conv kernel as the torch weight of the same module."""
    if kernel.ndim != 4:
        raise ValueError(f"{module}: expected a 4-D kernel, got {kernel.shape}")
    if module == "mask_deconv":
        return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    return np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))


def from_jax_variables(variables, expected_keys) -> dict:
    """Map flax `{"params": ..., "batch_stats": ...}` (nested dicts of numpy
    arrays) to a torch state_dict of numpy arrays for a module whose
    state_dict keys are `expected_keys`.

    Raises on a collection or leaf name the bridge does not know, on a torch
    key left unfilled, and on a flax leaf with no torch key to go to.
    """
    state = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unmapped flax collection {collection!r}")
        for path, value in _leaves(tree):
            *modules, leaf = path
            if leaf not in _LEAF_NAMES or not modules:
                raise KeyError(f"unmapped flax leaf {collection}/{'/'.join(path)}")
            value = np.asarray(value)
            if leaf == "kernel":
                value = convert_kernel(modules[-1], value)
            prefix = ".".join(modules)
            state[f"{prefix}.{_LEAF_NAMES[leaf]}"] = value
            if leaf == "mean":
                state[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)
    expected = set(expected_keys)
    unfilled = sorted(expected - state.keys())
    unmapped = sorted(state.keys() - expected)
    if unfilled or unmapped:
        raise KeyError(f"weight bridge mismatch: torch keys unfilled {unfilled}, "
                       f"flax leaves with no torch key {unmapped}")
    return state


def unconvert_kernel(module: str, weight: np.ndarray) -> np.ndarray:
    """The inverse of `convert_kernel`: a torch weight as the flax kernel."""
    if weight.ndim != 4:
        raise ValueError(f"{module}: expected a 4-D weight, got {weight.shape}")
    if module == "mask_deconv":
        return np.ascontiguousarray(weight.transpose(2, 3, 0, 1)[::-1, ::-1])
    return np.ascontiguousarray(weight.transpose(2, 3, 1, 0))


def flax_leaf(key: str, ndim: int):
    """The flax (collection, module path, leaf name) of a torch state_dict
    key whose value has `ndim` dims: a 4-D `weight` is a conv kernel, a 1-D
    one a BatchNorm scale. None for `num_batches_tracked`, which has no flax
    leaf."""
    *modules, name = key.split(".")
    if name == "num_batches_tracked":
        return None
    if name == "weight":
        return "params", modules, "kernel" if ndim == 4 else "scale"
    if name == "bias":
        return "params", modules, "bias"
    if name in ("running_mean", "running_var"):
        return "batch_stats", modules, name[len("running_"):]
    raise KeyError(f"unmapped torch key {key!r}")


def flax_path(key: str, ndim: int) -> str:
    """The slash-joined flax path of a torch parameter key, as the JAX
    package names it (`train/state.py::path_name`):
    'backbone.block1.conv_dw.weight' → 'backbone/block1/conv_dw/kernel'."""
    _, modules, leaf = flax_leaf(key, ndim)
    return "/".join(modules + [leaf])


def to_jax_variables(state_dict) -> dict:
    """A torch state_dict (numpy arrays or CPU tensors) as the flax variable
    tree `{"params": ..., "batch_stats": ...}` of the same network: the exact
    inverse of `from_jax_variables`."""
    variables = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        value = np.asarray(value.detach().cpu() if hasattr(value, "detach") else value)
        where = flax_leaf(key, value.ndim)
        if where is None:
            continue
        collection, modules, leaf = where
        if leaf == "kernel":
            value = unconvert_kernel(modules[-1], value)
        node = variables[collection]
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = value
    return variables


_LAYER_FIELDS = ("name", "kind", "kernel", "bias", "strides", "act", "groups",
                 "quantize", "w_q", "w_scale", "a_scale", "act_folded",
                 "bias_corr")


def from_jax_graph(graph) -> dict:
    """A layer graph of the JAX package's `quant` ({part: [Layer] or None},
    calibrated and quantized) as the port's `quant.Layer` graph, field by
    field. Arrays become numpy; a scalar activation scale stays a Python
    float, as `calibrate` leaves it (the fused-block test needs a float)."""
    from .quant import Layer

    def carry(layer):
        fields = {}
        for f in _LAYER_FIELDS:
            v = getattr(layer, f)
            if f in ("kernel", "bias", "w_q", "w_scale", "bias_corr") and v is not None:
                v = np.asarray(v)
            elif f == "a_scale":
                v = np.asarray(v, np.float32) if np.ndim(v) else float(v)
            elif f == "strides":
                v = tuple(int(s) for s in v)
            fields[f] = v
        return Layer(**fields)

    return {part: None if layers is None else [carry(l) for l in layers]
            for part, layers in graph.items()}
