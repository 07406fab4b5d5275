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
