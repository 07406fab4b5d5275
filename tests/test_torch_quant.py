"""The port's int8 detect path (mask_yolo_tpu_torch/quant.py) vs the JAX
package's, at TinyConfig size with 4 classes.

Weights: the spread tree of test_torch_slice (random BN statistics, scaled
mask_out) plus a random mask_deconv kernel. The JAX package's int8 graph
reads the deconv kernel unflipped (ROADMAP Queue 3), the port's follows
flax; so JAX gets the tree with that kernel flipped beforehand, and both
graphs then hold the same layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu import pipelines as jpipelines
from mask_yolo_tpu import quant as jquant
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet
from mask_yolo_tpu.ops import pallas_mask
from mask_yolo_tpu_torch import MaskYOLO, quant, weights
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.parallel.mesh import build_mesh
from mask_yolo_tpu_torch.serve import BatchingExecutor
from test_torch_slice import _spread

torch.set_num_threads(2)


class JaxQ(TinyConfig):
    NUM_CLASSES = 4
    LABELS = ["background", "square", "circle", "triangle"]
    COMPUTE_DTYPE = "float32"
    QUANT_DW_INT8 = True
    QUANT_FUSED_DS = True


PortQ = type("PortQ", (Config,), {
    **{k: v for k, v in vars(TinyConfig).items() if k.isupper()},
    **{k: v for k, v in vars(JaxQ).items() if k.isupper()},
    "QUANT_FUSED_MASK": True})


def spread_variables(seed=11):
    """(tree for the port, the same tree with mask_deconv flipped for JAX)."""
    rng = np.random.RandomState(seed)
    cfg = JaxQ()
    net = JaxNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                 top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=cfg.MASK_POOL_SIZE)
    v = _spread(net.init(jax.random.PRNGKey(5), jnp.zeros((1, *cfg.IMAGE_SHAPE)),
                         jnp.zeros((1, 4, 4)), train=False), rng)
    dk = v["params"]["mask"]["mask_deconv"]["kernel"]
    v["params"]["mask"]["mask_deconv"]["kernel"] = (
        rng.normal(0, 1.0 / np.sqrt(4 * dk.shape[2]), dk.shape).astype(np.float32))
    vf = jax.tree_util.tree_map(np.array, v)
    vf["params"]["mask"]["mask_deconv"]["kernel"] = np.ascontiguousarray(
        v["params"]["mask"]["mask_deconv"]["kernel"][::-1, ::-1])
    return v, vf, net


@pytest.fixture(scope="module")
def qsetup():
    v, vf, net = spread_variables()
    rng = np.random.RandomState(3)
    calib = rng.rand(4, *JaxQ.IMAGE_SHAPE).astype(np.float32)
    jdet = jquant.QuantizedDetector.from_variables(vf, JaxQ(), calib)
    return v, vf, net, calib, jdet


def _layers(graph):
    return [l for part in ("trunk", "neck", "yolo", "mask") for l in graph[part]]


def _same_tree(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if hasattr(a[key], "items"):
            _same_tree(a[key], b[key])
        else:
            assert a[key].dtype == np.asarray(b[key]).dtype
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_graph_equals_jax_and_bridge_inverts(qsetup):
    """(a) Exact: the same folded layers from the same tree, the deconv
    read as flax reads it; to_jax_variables inverts from_jax_variables."""
    v, vf, *_ = qsetup
    got = quant.build_layer_graph(v, PortQ())
    want = jquant.build_layer_graph(vf, JaxQ())
    assert [l.name for l in _layers(got)] == [l.name for l in _layers(want)]
    for g, w in zip(_layers(got), _layers(want)):
        assert (g.kind, tuple(g.strides), g.act, g.groups, g.quantize) == \
            (w.kind, tuple(w.strides), w.act, w.groups, w.quantize), g.name
        np.testing.assert_array_equal(g.kernel, np.asarray(w.kernel), err_msg=g.name)
        np.testing.assert_array_equal(g.bias, np.asarray(w.bias), err_msg=g.name)
    assert all(l.quantize for l in got["trunk"] if l.kind == "dw")   # QUANT_DW_INT8

    keys = MaskYOLO("inference", PortQ(), device="cpu").net.state_dict().keys()
    _same_tree(weights.to_jax_variables(weights.from_jax_variables(v, keys)),
               jax.tree_util.tree_map(np.asarray, v))


def test_calibration_matches_jax(qsetup):
    """(b) The port's own calibration: a_scale within rtol 1e-5 of JAX's
    (f32 convs sum in another order), a Python float, and identical w_q."""
    v, _, _, calib, jdet = qsetup
    graph = quant.quantize_weights(quant.calibrate(
        quant.build_layer_graph(v, PortQ()), PortQ(), torch.tensor(calib)))
    for g, w in zip(_layers(graph), _layers(jdet.graph)):
        assert isinstance(g.a_scale, float), g.name
        np.testing.assert_allclose(g.a_scale, w.a_scale, rtol=1e-5, err_msg=g.name)
        if w.quantize:
            np.testing.assert_array_equal(g.w_q, np.asarray(w.w_q), err_msg=g.name)
            np.testing.assert_array_equal(g.w_scale, np.asarray(w.w_scale), err_msg=g.name)


def test_int8_layers_match_jax(qsetup, rng):
    """(c) The JAX graph carried across by from_jax_graph: every int8 layer
    fed the same int8 input gives identical int32 accumulators (7×7 input,
    so stride-2 SAME pads 1 on each side)."""
    *_, jdet = qsetup
    graph = weights.from_jax_graph(jdet.graph)
    n = 0
    for g, w in zip(_layers(graph), _layers(jdet.graph)):
        if not (w.quantize and w.w_q is not None):
            continue
        cin = w.kernel.shape[2] * w.groups
        x_q = rng.randint(-127, 128, size=(2, 7, 7, cin)).astype(np.int8)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x_q), jnp.asarray(w.w_q), w.strides, "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=w.groups, preferred_element_type=jnp.int32)
        got = quant._conv_int8(torch.tensor(x_q), torch.tensor(g.w_q), g.strides, g.groups)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=g.name)
        n += 1
    assert n == len([l for l in _layers(graph) if l.quantize])


def test_int8_trunk_chain_matches_jax(qsetup):
    """(c) Each package chains the trunk on its own: the requantized int8
    tensors may differ by 1 LSB (the f32 epilogue may round differently
    across XLA and torch) on at most 0.5 % of elements."""
    _, _, _, calib, jdet = qsetup
    graph = weights.from_jax_graph(jdet.graph)
    layers_p, layers_j = graph["trunk"], jdet.graph["trunk"]
    xp, xj = torch.tensor(calib), jnp.asarray(calib)
    sp = sj = None
    diff = total = 0
    for i, (lp, lj) in enumerate(zip(layers_p, layers_j)):
        nxt = layers_j[i + 1].a_scale if i + 1 < len(layers_j) else None
        xp, sp = quant.run_layer_int8(lp, xp, sp, nxt)
        xj, sj = jquant.run_layer_int8(lj, xj, sj, nxt)
        if nxt is None:
            np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0, atol=1e-5)
            continue
        d = np.abs(xp.numpy().astype(np.int32) - np.asarray(xj).astype(np.int32))
        assert d.max() <= 1, lp.name
        diff += int((d > 0).sum())
        total += d.size
    print(f"int8 trunk chain: {diff} of {total} elements differ by 1 LSB "
          f"({diff / total:.2e})")
    assert diff / total <= 5e-3


def _np(out):
    return {k: val.numpy() for k, val in out.items()}


@pytest.fixture(scope="module")
def jax_slice_reference(qsetup):
    """The JAX int8 slice with both kernels, assembled by hand: its
    detect_fn does not pass interpret to the trunk (ROADMAP Queue 3)."""
    *_, jdet = qsetup
    cfg = JaxQ()
    w = pallas_mask.pack_mask_weights(jdet.graph, cfg.NUM_CLASSES)
    images = (np.random.RandomState(9).rand(3, *cfg.IMAGE_SHAPE) * 255).astype(np.uint8)

    @jax.jit
    def detect(im):
        return jpipelines.detect_from_callables(
            lambda x: jdet.trunk(x, fused_ds=True, interpret=True), jdet.mask_branch, im, cfg,
            fused_mask=lambda r, f, c: pallas_mask.fused_mask_branch(
                f, r, c, w, pool=cfg.MASK_POOL_SIZE, num_classes=cfg.NUM_CLASSES,
                interpret=True))

    return images, jax.device_get(detect(jnp.asarray(images)))


def test_int8_slice_matches_jax(qsetup, jax_slice_reference):
    """(f) The whole int8 slice, K1 and K3 on, from uint8 images: boxes,
    classes, scores and valid identical (the int8 grid is the same, so the
    decode is too), masks agree on >= 99.5 % of pixels."""
    *_, jdet = qsetup
    images, want = jax_slice_reference
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), PortQ())
    got = _np(det.detect_outputs(torch.tensor(images)))
    assert got["valid"].any() and got["masks"].any()
    for key in ("boxes", "classes", "scores", "valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    agree = np.mean(got["masks"] == want["masks"])
    print(f"int8 slice masks agree with JAX on {agree:.6f} of pixels")
    assert agree >= 0.995


def test_fused_and_chained_paths_agree(qsetup):
    """K1 + K3 against the chained layers of the same detector (the
    comparison chip_smoke makes on the card): boxes, classes, scores and
    valid identical, masks >= 99.5 %."""
    *_, jdet = qsetup
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), PortQ())
    images = torch.tensor((np.random.RandomState(4).rand(2, *JaxQ.IMAGE_SHAPE) * 255)
                          .astype(np.uint8))
    fused = _np(det.detect_outputs(images, fused_mask=True, fused_ds=True))
    chained = _np(det.detect_outputs(images, fused_mask=False, fused_ds=False))
    for key in ("boxes", "classes", "scores", "valid"):
        np.testing.assert_array_equal(fused[key], chained[key], err_msg=key)
    assert np.mean(fused["masks"] == chained["masks"]) >= 0.995


def test_model_quantize_and_serve(qsetup):
    """(g) MaskYOLO.quantize on uint8 images (÷255, the same scales as the
    float images), detect and detect_batch on the int8 path, a CPU
    BatchingExecutor answering 3 requests; load_jax_variables drops it."""
    v, *_ = qsetup
    model = MaskYOLO("inference", PortQ(), device="cpu")
    model.load_jax_variables(v)
    rng = np.random.RandomState(8)
    calib = (rng.rand(4, *JaxQ.IMAGE_SHAPE) * 255).astype(np.uint8)
    qdet = model.quantize(calib)
    ref = quant.QuantizedDetector.from_variables(v, PortQ(), calib.astype(np.float32) / 255.0,
                                               device="cpu")
    assert [l.a_scale for l in _layers(qdet.graph)] == [l.a_scale for l in _layers(ref.graph)]

    images = (rng.rand(3, *JaxQ.IMAGE_SHAPE) * 255).astype(np.uint8)
    batch = _np(model.detect_batch(images))
    direct = _np(qdet.detect_outputs(torch.tensor(images)))
    for key in batch:
        np.testing.assert_array_equal(batch[key], direct[key])
    res = model.detect(images[0], cs_threshold=0.0, display=False)[0]
    assert res["bboxes"].shape == (int(batch["valid"][0].sum()), 4)

    ex = BatchingExecutor(model, PortQ(), batch_size=2, max_delay_s=0.05, score_threshold=0.0)
    try:
        results = [f.result(timeout=60) for f in
                   [ex.submit(im, include_masks=True) for im in images]]
    finally:
        ex.shutdown()
    assert ex.stats["requests"] == 3 and ex.stats["batches"] >= 2
    assert len(results[0]["detections"]) == int(batch["valid"][0].sum())

    model.load_jax_variables(v)
    assert model._qdet is None


def test_seeded_model_quantizes_its_f32_draws():
    """A bf16 model folds the f32 seeded draws, not its rounded parameters."""
    cfg = type("B", (PortQ,), {"COMPUTE_DTYPE": "bfloat16"})()
    bf16 = MaskYOLO("inference", cfg, seed=3, device="cpu")
    f32 = MaskYOLO("inference", PortQ(), seed=3, device="cpu")
    for key, val in f32.net.state_dict().items():
        np.testing.assert_array_equal(bf16._host_state[key], val.numpy())
    w = bf16.net.state_dict()["mask.mask_conv1.weight"]
    assert w.dtype == torch.bfloat16
    assert not np.array_equal(w.float().numpy(), bf16._host_state["mask.mask_conv1.weight"])


@pytest.mark.parametrize("knob, value, item", [
    ("BACKBONE", "resnet50_fpn", "item 9"),
    ("QUANT_MASK_F32_LAYERS", ("mask_conv4",), None),
    ("QUANT_PER_CHANNEL_ACT", True, None),
    ("QUANT_CALIB_PCT", 99.9, None),
    ("QUANT_BIAS_CORRECT", True, None),
])
def test_unported_options_raise(qsetup, knob, value, item):
    """Every option, once held out, builds a detector that detects. The
    hybrid (non-mobilenet) int8 mode, ROADMAP Queue 1 `item` 9, needs the
    float network (net=) and raises ValueError without it, and with
    QUANT_FUSED_MASK, whose kernel takes one map (its parity with the JAX
    package is in test_torch_fpn.py); the int8 quality knobs' parity is in
    test_torch_quant_tools.py."""
    v, _, _, calib, _ = qsetup
    cfg = type("X", (PortQ,), {knob: value})()
    net = None
    if item is not None:
        with pytest.raises(ValueError, match="hybrid"):
            quant.QuantizedDetector.from_variables(v, cfg, calib[:1], device="cpu")
        net = MaskYOLO("inference", cfg, device="cpu").net
        with pytest.raises(ValueError, match="QUANT_FUSED_MASK"):
            quant.QuantizedDetector.from_variables(v, cfg, calib[:1], device="cpu", net=net)
        cfg = type("Y", (type(cfg),), {"QUANT_FUSED_MASK": False})()
    det = quant.QuantizedDetector.from_variables(v, cfg, calib[:1], device="cpu", net=net)
    out = det.detect_outputs(torch.tensor(calib[:1]), fused_mask=False)
    assert torch.isfinite(out["scores"]).all() and out["masks"].dtype == torch.bool


def test_unported_entry_points_raise(qsetup):
    *_, jdet = qsetup
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), PortQ())
    assert callable(det.infer_yolo_fn())          # ported (test_torch_infer_yolo.py)
    assert callable(det.finetune)                 # ported (test_torch_quant_tools.py)
    # ported: on a mesh each rank detects its local batch (test_torch_parallel.py)
    images = torch.zeros((1, *JaxQ.IMAGE_SHAPE))
    on_mesh = det.detect_outputs(images, mesh=build_mesh(None))
    for k, v in det.detect_outputs(images).items():
        assert torch.equal(on_mesh[k], v), k


def test_fused_ds_needs_a_float_scale(qsetup):
    """K1 fuses only when the pointwise scale is a Python float (a numpy
    scalar would silently never fuse; calibrate and from_jax_graph keep
    floats)."""
    *_, jdet = qsetup
    graph = weights.from_jax_graph(jdet.graph)
    dw, pw = graph["trunk"][1], graph["trunk"][2]     # block1
    assert dw.name == "block1/dw" and isinstance(pw.a_scale, float)
    assert quant._fusable_ds_pair(dw, pw, dw.a_scale)
    pw.a_scale = np.float32(pw.a_scale)
    assert not quant._fusable_ds_pair(dw, pw, dw.a_scale)
    assert not quant._fusable_ds_pair(graph["trunk"][3], graph["trunk"][4], 0.1)  # stride 2
