"""The port's detection-only path (`infer_yolo_outputs`, float and int8, and
`MaskYOLO.infer_yolo`) against the JAX package's on the same bridged
weights and seeded images, at TinyConfig size and at the 64x96 (grid 2x3)
point of tests/test_rectangular.py, where `detect_outputs` is held too.

OBJ_THRESHOLD is lowered to 0.05 so that, at random weights, most boxes
pass it and the per-class greedy NMS has work to do.

Tolerances. Float path, f32 on both sides: boxes within 1e-5 (decode's exp
and sigmoid may differ by an ULP between XLA and torch); scores within
5e-5 relative: they are sigmoid x softmax of logits that come out of 30
conv layers agreeing to 1e-4 of the grid's scale (test_torch_slice.py) and
that this file scales 6x to spread them (measured: 1.4e-5); classes and
valid equal. int8 path: both packages run the same integer graph, so the
grid agrees up to the documented 1-LSB hand-off, which moved no class or
valid flag here: the same limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO
from mask_yolo_tpu import pipelines as jpipelines
from mask_yolo_tpu import quant as jquant
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet
from mask_yolo_tpu_torch import MaskYOLO, pipelines, quant, weights
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.utils.host_ops import BoundBox
from test_rectangular import RectShapesConfig
from test_torch_quant import JaxQ, spread_variables
from test_torch_slice import _spread

torch.set_num_threads(2)

KNOBS = {"full_grid": {}, "top_n": {"INFER_YOLO_TOP_N": 4},
         "per_class_k": {"INFER_YOLO_PER_CLASS_K": 3, "INFER_YOLO_TOP_N": 4}}


def _pair(base, **over):
    """(JAX config, port config) of `base` with OBJ_THRESHOLD 0.05 and `over`."""
    jcfg = type("J" + base.__name__, (base,), {"OBJ_THRESHOLD": 0.05, **over})()
    values = {k: getattr(jcfg, k) for k in dir(jcfg) if k.isupper()}
    return jcfg, type("P" + base.__name__, (Config,), values)()


def _spread_scores(variables, config, by=6.0):
    """Scale conv_23's confidence and class columns (not xy/wh, which exp
    would blow up), so that scores spread and boxes pass the threshold."""
    kernel = variables["params"]["yolo"]["conv_23"]["kernel"]
    cols = np.arange(kernel.shape[-1]) % (5 + config.NUM_CLASSES) >= 4
    variables["params"]["yolo"]["conv_23"]["kernel"] = np.where(cols, kernel * by, kernel)


def _setup(base, seed):
    rng = np.random.RandomState(seed)
    jcfg, _ = _pair(base)
    net = JaxNet(num_classes=jcfg.NUM_CLASSES, n_box=jcfg.N_BOX,
                 top_feature_map_depth=jcfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=jcfg.MASK_POOL_SIZE)
    variables = _spread(net.init(jax.random.PRNGKey(1), jnp.zeros((1, *jcfg.IMAGE_SHAPE)),
                                 jnp.zeros((1, 4, 4)), train=False), rng)
    _spread_scores(variables, jcfg)
    images = (rng.rand(3, *jcfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    return net, variables, images


@pytest.fixture(scope="module")
def tiny():
    return _setup(TinyConfig, 21)


@pytest.fixture(scope="module")
def rect():
    return _setup(RectShapesConfig, 22)


def _port_model(pcfg, variables):
    model = MaskYOLO("inference", pcfg, seed=0, device="cpu")
    model.load_jax_variables(variables)
    return model


def _compare_infer(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["classes"].dtype == np.int32 and got["valid"].dtype == bool
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=5e-5, atol=1e-6)
    return got


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_infer_yolo_outputs_match_jax(tiny, knobs):
    net, variables, images = tiny
    jcfg, pcfg = _pair(TinyConfig, **KNOBS[knobs])
    want = jpipelines.infer_yolo_outputs(net, variables, jnp.asarray(images), jcfg)
    model = _port_model(pcfg, variables)
    with torch.inference_mode():
        got = _compare_infer(pipelines.infer_yolo_outputs(model.net, torch.tensor(images), pcfg),
                             want)
    n = jcfg.GRID_H * jcfg.GRID_W * jcfg.N_BOX
    assert got["boxes"].shape == (3, n, 4)
    if knobs == "full_grid":
        # the NMS had work: boxes valid and boxes dropped after passing the threshold
        assert 0 < got["valid"].sum() < got["valid"].size


def test_knobs_agree_while_they_keep_every_live_box(tiny):
    """TOP_N and PER_CLASS_K at the grid's size and above run the full-grid
    path; a K that holds every class's live boxes gives the same result."""
    net, variables, images = tiny
    outs = []
    for over in ({}, {"INFER_YOLO_TOP_N": 8}, {"INFER_YOLO_PER_CLASS_K": 7}):
        _, pcfg = _pair(TinyConfig, **over)
        model = _port_model(pcfg, variables)
        with torch.inference_mode():
            outs.append(pipelines.infer_yolo_outputs(model.net, torch.tensor(images), pcfg))
    for other in outs[1:]:
        for key in outs[0]:
            assert torch.equal(outs[0][key], other[key]), key


def test_rectangular_infer_yolo_and_detect_match_jax(rect):
    """A non-square IMAGE_SHAPE (64x96, grid 2x3) through both pipelines:
    x is normalized by GRID_W and y by GRID_H, the pixel boxes scale by
    (W, H), the masks paste on an [H, W] canvas."""
    net, variables, images = rect
    jcfg, pcfg = _pair(RectShapesConfig)
    model = _port_model(pcfg, variables)
    want = jpipelines.infer_yolo_outputs(net, variables, jnp.asarray(images), jcfg)
    with torch.inference_mode():
        got = _compare_infer(pipelines.infer_yolo_outputs(model.net, torch.tensor(images), pcfg),
                             want)
    assert got["boxes"].shape == (3, 2 * 3 * 2, 4) and got["valid"].any()
    want = jax.device_get(jpipelines.detect_outputs(net, variables, jnp.asarray(images), jcfg))
    got = {k: v.numpy() for k, v in model.detect_batch(images).items()}
    assert got["masks"].shape == (3, jcfg.DETECTION_MAX_INSTANCES, 64, 96)
    assert got["valid"].any() and got["masks"].any()
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=5e-5, atol=1e-6)
    # pixel boxes: the normalized boxes' 1e-5 times the 96-pixel width
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-5, atol=1e-3)
    assert np.mean(got["masks"] == want["masks"]) >= 0.999


def test_int8_infer_yolo_matches_jax():
    """QuantizedDetector.infer_yolo_outputs on the JAX package's own graph
    (carried across by from_jax_graph), K1's plain version on; the JAX side
    runs its Pallas K1 in interpret mode, assembled by hand because its
    infer_yolo_fn passes no `interpret` to the trunk."""
    _, vf, _ = spread_variables()
    jcfg, pcfg = _pair(JaxQ)
    _spread_scores(vf, jcfg)
    rng = np.random.RandomState(4)
    calib = rng.rand(4, *jcfg.IMAGE_SHAPE).astype(np.float32)
    images = (rng.rand(3, *jcfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    jdet = jquant.QuantizedDetector.from_variables(vf, jcfg, calib)
    want = jax.jit(lambda im: jpipelines.infer_yolo_from_callables(
        lambda x: jdet.trunk(x, fused_ds=True, interpret=True), im, jcfg))(jnp.asarray(images))
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), pcfg)
    got = _compare_infer(det.infer_yolo_outputs(torch.tensor(images)), want)
    assert 0 < got["valid"].sum() < got["valid"].size
    chained = det.infer_yolo_outputs(torch.tensor(images), fused_ds=False)
    np.testing.assert_array_equal(chained["valid"].numpy(), got["valid"])


def test_model_infer_yolo_returns_the_jax_models_boxes(tiny, tmp_path):
    """MaskYOLO.infer_yolo: BoundBoxes equal to the JAX model's (labels
    equal, coordinates and scores to 1e-5), float before quantize and int8
    after it, dropped again by a weight change."""
    net, variables, images = tiny
    jcfg, pcfg = _pair(TinyConfig)
    jmodel = JaxMaskYOLO("inference", jcfg)
    jmodel.params, jmodel.batch_stats = variables["params"], variables["batch_stats"]
    model = _port_model(pcfg, variables)
    want = jmodel.infer_yolo(images[0], display=False)
    got = model.infer_yolo(images[0], display=False)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, BoundBox) and g.get_label() == w.get_label()
        np.testing.assert_allclose([g.xmin, g.ymin, g.xmax, g.ymax, g.get_score()],
                                   [w.xmin, w.ymin, w.xmax, w.ymax, w.get_score()],
                                   rtol=1e-5, atol=1e-5)
        assert g["label"] == g.label
    # display=True is the default, as in the JAX package: both draw a figure
    model.infer_yolo(images[0], save_path=str(tmp_path / "yolo"))
    model.detect(images[0], save_path=str(tmp_path / "det"), cs_threshold=0.0)
    assert [p.name[:9] for p in (tmp_path / "yolo").iterdir()] == ["InferYOLO"]
    assert [p.name[:13] for p in (tmp_path / "det").iterdir()] == ["InferMaskYOLO"]
    with pytest.raises(ValueError):
        model.infer_yolo(images[0].astype(np.float32))

    # after quantize() infer_yolo serves the int8 trunk; a weight change drops it
    model.quantize(images)
    q = model._qdet.infer_yolo_outputs(torch.tensor(images[:1]))
    served = model.infer_yolo(images[0], display=False)
    assert len(served) == int(q["valid"].sum())
    path = str(tmp_path / "w.pt")
    model.save_weights(path)
    again = model.infer_yolo(images[0], weights_dir=path, display=False)    # drops the detector
    assert model._qdet is None and len(again) == len(got)
    # detect takes the JAX package's parameters in its order
    res = model.detect(images[0], path, str(tmp_path), 0.0)[0]
    assert res["full_masks"].shape[:2] == (64, 64)
    out = model.detect_batch(images, weights_dir=path)
    assert out["boxes"].shape[0] == 3


def test_decode_masks_matches_jax(tiny):
    net, variables, images = tiny
    jcfg, pcfg = _pair(TinyConfig)
    rng = np.random.RandomState(0)
    det = np.concatenate([rng.uniform(0, 30, (1, 5, 2)), rng.uniform(34, 60, (1, 5, 2)),
                          rng.rand(1, 5, 1), rng.randint(0, 3, (1, 5, 1))], -1).astype(np.float32)
    det[0, 2, 2:4] = det[0, 2, 0:2]             # a zero-area box is dropped
    masks = rng.rand(1, 5, 8, 8, 3).astype(np.float32)
    want = JaxMaskYOLO("inference", jcfg).decode_masks(det, masks, jcfg.IMAGE_SHAPE)
    got = _port_model(pcfg, variables).decode_masks(det, masks, pcfg.IMAGE_SHAPE)
    assert got[3].shape == (64, 64, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
