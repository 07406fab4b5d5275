"""The port's graft entry points (mask_yolo_tpu_torch/graft_entry.py)
against the root `__graft_entry__.py` of the JAX package, on the CPU.

entry(): both packages' flagship detect (ShapesConfig at full width, bf16)
on the variables of JAX's entry(), with test_torch_slice.py's `_spread`
(random BatchNorm statistics and affine, mask_out x8: at flax's init every
score sits within 1e-5 of 0.5 and every mask probability within 1e-4 of
it, so the top-K order and the masks are rounding), carried across by
`weights.from_jax_variables`, on 8 seeded noise images.

In f32 the two packages' detect agree (the same weights through the
port's ShapesConfig detect_batch): classes and valid identical, boxes
within 1e-3 of the image size, masks on >= 99.9 % of pixels. In bf16 each
package rounds at its own places and a near-tie of scores reorders the
top K, so detections are matched by box, not by slot, and the port's bf16
entry is held to be no farther from JAX's bf16 entry than BF16_FLOOR (1.5)
times the distance between JAX's own bf16 and f32 detect, by each measure:
the mismatch of matched masks and classes, one minus the median IoU of
matched boxes, and the largest gap of the sorted scores (the method of
tests/test_torch_train.py's bf16 gradient test). Measured: the port
0.032 / 0.038 / 0.057 / 0.0092 from JAX, JAX's bf16 0.031 / 0.050 / 0.044 /
0.0127 from its f32. valid is identical.

The port's torch.export program of entry()'s fn (the weights as inputs)
gives the eager call's outputs bit for bit, with one crop_rois op.

dryrun_multichip(2, device="cpu"): two gloo ranks, mp 2, on the JAX
dryrun's initial variables (flax's init at PRNGKey(0)); its loss is held
to the loss JAX's dryrun_multichip(2) prints (run in this process on the
conftest's virtual CPU devices) within rel 1e-4, plus half the last digit
that line prints (measured: 1.169689 against the printed 1.1696).
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import __graft_entry__ as jentry  # noqa: E402
from mask_yolo_tpu import pipelines as jpipelines  # noqa: E402
from mask_yolo_tpu.data.shapes import ShapesConfig as JaxShapesConfig  # noqa: E402
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet  # noqa: E402
from mask_yolo_tpu_torch import MaskYOLO, graft_entry, weights  # noqa: E402
from mask_yolo_tpu_torch.data.shapes import ShapesConfig  # noqa: E402
from mask_yolo_tpu_torch.export import custom_op_counts  # noqa: E402
from test_torch_slice import _spread  # noqa: E402

torch.set_num_threads(2)

BF16_FLOOR = 1.5
DRYRUN_REL = 1e-4


def host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def np_out(out):
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def flagship():
    """JAX's entry() forward and (spread) variables, the images, JAX's bf16
    and f32 detect on them, and the port's entry() state loaded with the
    same variables."""
    forward, (variables, _) = jentry.entry()
    v = _spread(host(variables), np.random.RandomState(7))
    images = np.random.RandomState(0).rand(graft_entry.ENTRY_BATCH, 224, 224, 3).astype(np.float32)
    jcfg = JaxShapesConfig()
    jnet32 = JaxNet(num_classes=jcfg.NUM_CLASSES, n_box=jcfg.N_BOX,
                    top_feature_map_depth=jcfg.TOP_FEATURE_MAP_DEPTH,
                    mask_pool_size=jcfg.MASK_POOL_SIZE, backbone=jcfg.BACKBONE)
    want16 = host(jax.jit(forward)(v, jnp.asarray(images)))
    want32 = host(jax.jit(lambda v, x: jpipelines.detect_outputs(jnet32, v, x, jcfg))(
        v, jnp.asarray(images)))
    fn, (state, example) = graft_entry.entry(device="cpu")
    sd = weights.from_jax_variables(v, state.keys())
    state = {k: torch.tensor(sd[k]).to(t.dtype) for k, t in state.items()}
    return v, images, want16, want32, fn, state, example


def box_iou(a, b):
    """IoU of box a [4] with each of b [N, 4] (pixel xyxy)."""
    lo, hi = np.maximum(a[:2], b[:, :2]), np.minimum(a[2:], b[:, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])   # noqa: E731
    return inter / (area(a) + area(b) - inter)


def distance(got, want):
    """(mask mismatch, class mismatch, 1 - median IoU, sorted-score gap) of
    two detect dicts, each detection of `want` matched to the box of `got`
    it overlaps most in the same image."""
    masks, classes, ious = [], [], []
    for i in range(len(want["boxes"])):
        for j in range(want["boxes"].shape[1]):
            overlap = box_iou(want["boxes"][i, j], got["boxes"][i])
            p = int(np.argmax(overlap))
            ious.append(overlap[p])
            masks.append(np.mean(want["masks"][i, j] != got["masks"][i, p]))
            classes.append(want["classes"][i, j] != got["classes"][i, p])
    scores = np.abs(np.sort(want["scores"], axis=1) - np.sort(got["scores"], axis=1)).max()
    return np.array([np.mean(masks), np.mean(classes), 1 - np.median(ious), scores])


def test_entry_matches_jax_entry(flagship):
    """The port's entry() fn against JAX's entry() forward (docstring): in
    f32 the same detect, in bf16 within BF16_FLOOR of JAX's own bf16 noise."""
    v, images, want16, want32, fn, state, example = flagship
    assert example.shape == (graft_entry.ENTRY_BATCH, 224, 224, 3) and example.device.type == "cpu"
    model = MaskYOLO("inference", ShapesConfig(), device="cpu")
    model.load_jax_variables(v)
    got32 = np_out(model.detect_batch(images))
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got32[key], want32[key])
    assert np.abs(got32["boxes"] - want32["boxes"]).max() <= 1e-3 * 224
    assert np.mean(got32["masks"] == want32["masks"]) >= 0.999

    got16 = np_out(fn(state, torch.from_numpy(images)))
    np.testing.assert_array_equal(got16["valid"], want16["valid"])
    gap, floor = distance(got16, want16), distance(want32, want16)
    print("port bf16 from JAX bf16", gap, "JAX bf16 from JAX f32", floor)
    assert (gap <= BF16_FLOOR * floor).all(), (gap, floor)


def test_entry_export_equals_the_eager_call(flagship):
    """torch.export of fn (weights as inputs): one crop_rois op, and the
    program's outputs equal the eager call's bit for bit."""
    _, images, _, _, fn, state, _ = flagship
    x = torch.from_numpy(images[:2])
    program = graft_entry.export_entry(fn, (state, x))
    assert custom_op_counts(program) == {"crop_rois": 1}
    want, got = fn(state, x), program.module()(state, x)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_dryrun_multichip_matches_jax(capsys):
    """dryrun_multichip(2, device="cpu") on the JAX dryrun's initial
    variables against the loss JAX's dryrun_multichip(2) prints."""
    cfg = graft_entry.dryrun_config(2)
    net = JaxNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                 top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=cfg.MASK_POOL_SIZE, backbone=cfg.BACKBONE)
    variables = host(jax.jit(lambda r: net.init(r, jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 8, 4)),
                                                train=False))(jax.random.PRNGKey(0)))
    jentry.dryrun_multichip(2)
    printed = capsys.readouterr().out
    want = float(re.search(r"loss=([-\d.]+)", printed).group(1))
    assert "mesh=(1, 2)" in printed and "step=1 detect=(2, 4, 4) OK" in printed, printed

    got = graft_entry.dryrun_multichip(2, device="cpu", variables=variables)
    line = capsys.readouterr().out
    assert (got["mesh"], got["step"], got["detect"]) == ([1, 2], 1, [2, 4, 4])
    assert f"mesh=(1, 2) axes=('data', 'model') loss={got['loss']:.4f} step=1 " \
           f"detect=(2, 4, 4) OK" in line, line
    print("dryrun loss", got["loss"], "JAX prints", want)
    assert abs(got["loss"] - want) <= DRYRUN_REL * abs(want) + 5e-5, (got["loss"], want)


def test_entry_points_run_on_the_card_unless_asked():
    """Both entry points default to the card, and raise without one; the
    dryrun asked for more cards than there are raises before any process
    starts."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
