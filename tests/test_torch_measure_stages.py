"""The port's stage profilers (mask_yolo_tpu_torch/tools/profile_stages.py,
profile_stages_416.py, profile_infer_yolo.py) against the JAX package, at
TinyConfig size.

Each named stage callable of a port tool, on weights bridged from flax, is
held against the same prefix composed with the JAX package's functions as
the JAX tool composes it inside its main() (the lines cited in each test):
`decode_detections`, `lax.top_k`, `index_order_class_nms_mask`,
`crop_and_resize`, the network's `trunk` / `mask_branch` and
`QuantizedDetector.trunk` / `mask_branch`. The bounds are those of the
existing parity tests: float (f32) stages tests/test_torch_slice.py's (the
trunk 1e-4 of its output's scale; scores 1e-4, boxes 1e-4 rel / 1e-2 abs,
classes and keep identical, masks 1e-4 abs on the same inputs), int8 stages
tests/test_torch_quant.py's (the port's detector carries the JAX graph
across, `weights.from_jax_graph`: the int8 grid is the same, so decode,
top-K and NMS are identical; crops to bf16's rounding). Each `full` stage
equals the port's own library entry point (`detect_outputs`,
`QuantizedDetector.detect_outputs` / `infer_yolo_outputs`) exactly. The
tools themselves run through main([... "--device", "cpu"]) and print rows
with the JAX tool's keys.
"""

import ast
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from conftest import TinyConfig  # noqa: E402
from mask_yolo_tpu import pipelines as jpipelines  # noqa: E402
from mask_yolo_tpu import quant as jquant  # noqa: E402
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet  # noqa: E402
from mask_yolo_tpu.ops.boxes import decode_detections, decode_yolo_proposals  # noqa: E402
from mask_yolo_tpu.ops.nms import (class_aware_nms, greedy_nms_mask,  # noqa: E402
                                   index_order_class_nms_mask, reference_softmax)
from mask_yolo_tpu.ops.roi_align import crop_and_resize  # noqa: E402
from mask_yolo_tpu_torch import MaskYOLO, pipelines, quant, weights  # noqa: E402
from mask_yolo_tpu_torch.config import Config  # noqa: E402
from mask_yolo_tpu_torch.tools import (profile_infer_yolo, profile_stages,  # noqa: E402
                                       profile_stages_416)
from test_torch_quant import spread_variables  # noqa: E402
from test_torch_slice import _spread  # noqa: E402

torch.set_num_threads(2)

PortTiny = type("PortTiny", (Config,), {k: v for k, v in vars(TinyConfig).items()
                                        if k.isupper()})
TRUNK_REL, SCORE_REL, BOX_REL, BOX_ABS, MASK_ABS = 1e-4, 1e-4, 1e-4, 1e-2, 1e-4
CROP_REL = 2.0 ** -7      # one bf16 rounding of the crop's largest value


def jax_json_keys(name):
    """The key sets of the dict literals the JAX tools/<name>.py prints
    through json.dumps (error lines left out)."""
    sets = []
    for node in ast.walk(ast.parse((ROOT / "tools" / f"{name}.py").read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            keys = {k.value for k in node.args[0].keys if isinstance(k, ast.Constant)}
            if keys and "error" not in keys:
                sets.append(keys)
    return sets


def assert_rows_carry_jax_keys(rows, jax_sets):
    """Every JAX row kind has a port row whose keys are a superset; every
    timing of a port row is finite and > 0."""
    for keys in jax_sets:
        assert any(keys <= set(r) for r in rows), keys
    for r in rows:
        assert "error" not in r, r
        for k in ("ms", "us_per_img", "img_per_s"):
            if k in r:
                assert np.isfinite(r[k]) and r[k] > 0, (k, r)
        assert r.get("device_busy_share", None) is None   # no device time on the CPU


def np_tree(out):
    if isinstance(out, dict):
        return {k: np_tree(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return [np_tree(v) for v in out]
    return np.asarray(out) if not torch.is_tensor(out) else out.float().numpy() \
        if out.dtype == torch.bfloat16 else out.numpy()


def rel_close(got, want, tol):
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# profile_stages: the float pipeline (tools/profile_stages.py:68-110)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def float_setup():
    rng = np.random.RandomState(7)
    jcfg = TinyConfig()
    net = JaxNet(num_classes=jcfg.NUM_CLASSES, n_box=jcfg.N_BOX,
                 top_feature_map_depth=jcfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=jcfg.MASK_POOL_SIZE)
    v = _spread(net.init(jax.random.PRNGKey(0), jnp.zeros((1, *jcfg.IMAGE_SHAPE)),
                         jnp.zeros((1, 4, 4)), train=False), rng)
    model = MaskYOLO("inference", PortTiny(), seed=0, device="cpu")
    model.load_jax_variables(v)
    images = rng.rand(3, *jcfg.IMAGE_SHAPE).astype(np.float32)
    return jcfg, net, v, model, images


def jax_float_stages(net, v, cfg):
    """tools/profile_stages.py:68-107, without the checksums."""
    k = cfg.DETECTION_MAX_INSTANCES

    def top(images):
        grid, fmap = net.apply(v, images, train=False, method=net.trunk)
        det = decode_detections(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
        boxes, scores, classes = det[..., :4], det[..., 4], det[..., 5].astype(jnp.int32)
        area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0
        top_scores, idx = jax.lax.top_k(jnp.where(area_ok, scores, -1.0), k)
        return (jnp.take_along_axis(boxes, idx[..., None], axis=1), top_scores,
                jnp.take_along_axis(classes, idx, axis=1), fmap)

    def stage_trunk(images):
        return net.apply(v, images, train=False, method=net.trunk)

    def stage_decode(images):
        grid, fmap = net.apply(v, images, train=False, method=net.trunk)
        return decode_detections(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W), fmap

    def stage_nms(images):
        top_boxes, top_scores, top_classes, fmap = top(images)
        valid = top_scores > cfg.OBJ_THRESHOLD
        keep = jax.vmap(lambda bx, cl, va: index_order_class_nms_mask(bx, cl, va, 0.7))(
            top_boxes, top_classes, valid)
        return top_boxes, top_scores, keep, fmap

    def stage_mask(images):
        top_boxes, top_scores, top_classes, fmap = top(images)
        pred = net.apply(v, top_boxes, fmap, train=False, method=net.mask_branch)
        onehot = jax.nn.one_hot(top_classes, cfg.NUM_CLASSES, dtype=pred.dtype)
        return jnp.einsum("bkhwc,bkc->bkhw", pred, onehot), top_scores

    def stage_full(images):
        return jpipelines.detect_outputs(net, v, images, cfg)

    return dict(zip(profile_stages.STAGE_NAMES,
                    (stage_trunk, stage_decode, stage_nms, stage_mask, stage_full)))


def test_profile_stages_prefixes_match_jax(float_setup):
    jcfg, net, v, model, images = float_setup
    want = {name: jax.device_get(fn(jnp.asarray(images)))
            for name, fn in jax_float_stages(net, v, jcfg).items()}
    x = torch.tensor(images)
    with torch.inference_mode():
        got = {name: np_tree(fn(x))
               for name, fn in profile_stages.build_stages(model.net, PortTiny())}
        lib = np_tree(pipelines.detect_outputs(model.net, x, PortTiny()))
    assert list(got) == list(want) == list(profile_stages.STAGE_NAMES)
    for g, w in zip(got["trunk"], want["trunk"]):
        rel_close(g, np.asarray(w), TRUNK_REL)
    dec, jdec = got["+decode"][0], np.asarray(want["+decode"][0])
    np.testing.assert_array_equal(dec[..., 5], jdec[..., 5])                  # classes
    np.testing.assert_allclose(dec[..., 4], jdec[..., 4], rtol=SCORE_REL, atol=1e-5)
    np.testing.assert_allclose(dec[..., :4], jdec[..., :4], rtol=BOX_REL, atol=1e-5)
    boxes, scores, keep, _ = got["+nms"]
    np.testing.assert_allclose(boxes, want["+nms"][0], rtol=BOX_REL, atol=1e-5)
    np.testing.assert_allclose(scores, want["+nms"][1], rtol=SCORE_REL, atol=1e-5)
    np.testing.assert_array_equal(keep, want["+nms"][2])
    assert keep.any()
    np.testing.assert_allclose(got["+mask"][0], want["+mask"][0], rtol=0, atol=MASK_ABS)
    assert np.abs(np.asarray(want["+mask"][0]) - 0.5).mean() > 0.1   # masks spread
    for key in ("classes", "valid", "scores", "boxes", "masks"):
        np.testing.assert_array_equal(got["full"][key], lib[key], err_msg=key)
    np.testing.assert_array_equal(got["full"]["valid"], want["full"]["valid"])
    np.testing.assert_allclose(got["full"]["scores"], want["full"]["scores"], rtol=1e-4,
                               atol=1e-5)


def test_profile_stages_prints_the_jax_rows(capsys):
    """main() of the tool at batch 2 on TinyConfig-sized ShapesConfig (the
    tool's config, its widths cut): one row a stage, every key the JAX
    tool prints (`{name} {ms} ms/iter {us} µs/img`, :146) plus delta_us."""
    from mask_yolo_tpu_torch.data.shapes import ShapesConfig

    tiny = type("S", (ShapesConfig,), {**{k: v for k, v in vars(TinyConfig).items()
                                          if k.isupper() and k not in ("NAME", "LABELS",
                                                                       "NUM_CLASSES")},
                                       "COMPUTE_DTYPE": "bfloat16"})
    orig = profile_stages.bench_config
    profile_stages.bench_config = tiny
    try:
        rows = profile_stages.main(["2", "trunk", "full", "--device", "cpu"])
    finally:
        profile_stages.bench_config = orig
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and [r["stage"] for r in rows] == ["trunk", "full"]
    assert_rows_carry_jax_keys(rows, [{"stage", "ms", "us_per_img", "delta_us"}])
    assert all(r["batch"] == 2 and r["device"] == "cpu" for r in rows)


# ---------------------------------------------------------------------------
# the int8 stages (tools/profile_stages_416.py:93-150,
# tools/profile_infer_yolo.py:94-150)
# ---------------------------------------------------------------------------


class JaxInt8(TinyConfig):
    NUM_CLASSES = 4
    LABELS = ["background", "square", "circle", "triangle"]
    COMPUTE_DTYPE = "float32"
    QUANT_DW_INT8 = True
    MASK_TOP_K = 2            # < DETECTION_MAX_INSTANCES: the valid-first re-sort runs
    INFER_YOLO_TOP_N = 0
    INFER_YOLO_PER_CLASS_K = 0


def port_int8_config(**over):
    return type("PortInt8", (Config,), {**{k: v for k, v in vars(TinyConfig).items()
                                           if k.isupper()},
                                        **{k: v for k, v in vars(JaxInt8).items()
                                           if k.isupper()}, **over})()


@pytest.fixture(scope="module")
def int8_setup():
    v, vf, _ = spread_variables()
    calib = np.random.RandomState(3).rand(4, *JaxInt8.IMAGE_SHAPE).astype(np.float32)
    jdet = jquant.QuantizedDetector.from_variables(vf, JaxInt8(), calib)
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), port_int8_config())
    images = np.random.RandomState(9).rand(3, *JaxInt8.IMAGE_SHAPE).astype(np.float32)
    return jdet, det, images


def jax_416_stages(det, cfg):
    """tools/profile_stages_416.py:93-150, without the checksums."""
    k = cfg.DETECTION_MAX_INSTANCES
    kp = min(int(cfg.MASK_TOP_K or 0) or k, k)
    pool = cfg.MASK_POOL_SIZE
    det_nms = float(cfg.DETECTION_NMS_THRESHOLD)

    def upto_decode(images):
        grid, fmap = det.trunk(images)
        d = decode_detections(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
        boxes, scores = d[..., :4], d[..., 4]
        classes = d[..., 5].astype(jnp.int32)
        area_ok = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])) > 0
        top_scores, idx = jax.lax.top_k(jnp.where(area_ok, scores, -1.0), k)
        top_boxes = jnp.take_along_axis(boxes, idx[..., None], axis=1)
        top_classes = jnp.take_along_axis(classes, idx, axis=1)
        valid = top_scores > cfg.OBJ_THRESHOLD
        keep = jax.vmap(lambda bx, cl, va: index_order_class_nms_mask(bx, cl, va, det_nms))(
            top_boxes, top_classes, valid)
        valid = valid & keep
        if kp < k:
            _, order = jax.lax.top_k(jnp.where(valid, top_scores + 2.0, top_scores), k)
            top_boxes = jnp.take_along_axis(top_boxes, order[..., None], axis=1)
            top_scores = jnp.take_along_axis(top_scores, order, axis=1)
            top_classes = jnp.take_along_axis(top_classes, order, axis=1)
            valid = jnp.take_along_axis(valid, order, axis=1)
        return fmap, top_boxes, top_scores, top_classes, valid

    def stage_crop(images):
        fmap, b_, s_, _, v_ = upto_decode(images)
        return crop_and_resize(fmap, b_[:, :kp], (pool, pool), dtype=jnp.bfloat16), s_, v_

    def stage_maskconvs(images):
        fmap, b_, s_, _, v_ = upto_decode(images)
        x = crop_and_resize(fmap, b_[:, :kp], (pool, pool), dtype=jnp.bfloat16)
        x = x.astype(jnp.float32).reshape(x.shape[0] * kp, pool, pool, x.shape[-1])
        return jquant.run_layers(det.graph["mask"], x, quant=True), s_, v_

    def stage_select(images):
        fmap, b_, s_, c_, v_ = upto_decode(images)
        m = det.mask_branch(b_[:, :kp], fmap)
        onehot = jax.nn.one_hot(c_[:, :kp], cfg.NUM_CLASSES, dtype=m.dtype)
        return jnp.einsum("bkhwc,bkc->bkhw", m, onehot), s_, v_

    return {"trunk": det.trunk, "+decode_nms": lambda im: upto_decode(im)[1:],
            "+crop": stage_crop, "+maskconvs": stage_maskconvs, "+select": stage_select}


def test_profile_stages_416_prefixes_match_jax(int8_setup):
    """Trunk, decode + NMS + re-sort, crop (bf16), the int8 mask convs and
    the class select against the JAX tool's compositions; full equals the
    detector's detect_outputs exactly."""
    jdet, det, images = int8_setup
    want = {n: jax.device_get(fn(jnp.asarray(images)))
            for n, fn in jax_416_stages(jdet, JaxInt8()).items()}
    x = torch.tensor(images)
    with torch.inference_mode():
        got = {n: np_tree(fn(x)) for n, fn in
               profile_stages_416.build_stages(det, port_int8_config())}
        lib = np_tree(det.detect_outputs(x))
    assert list(got) == list(profile_stages_416.STAGE_NAMES)
    for g, w in zip(got["trunk"], want["trunk"]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    boxes, scores, classes, valid = got["+decode_nms"]
    np.testing.assert_allclose(boxes, want["+decode_nms"][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(scores, want["+decode_nms"][1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(classes, want["+decode_nms"][2])
    np.testing.assert_array_equal(valid, want["+decode_nms"][3])
    assert valid.any()
    crop, jcrop = got["+crop"][0], np.asarray(want["+crop"][0], np.float32)
    rel_close(crop, jcrop.reshape(crop.shape), CROP_REL)
    masks, jmasks = got["+maskconvs"][0], np.asarray(want["+maskconvs"][0])
    np.testing.assert_allclose(masks.reshape(jmasks.shape), jmasks, rtol=0, atol=MASK_ABS)
    np.testing.assert_allclose(got["+select"][0], want["+select"][0], rtol=0, atol=MASK_ABS)
    for key in lib:
        np.testing.assert_array_equal(got["full"][key], lib[key], err_msg=key)


def jax_infer_stages(det, cfg):
    """tools/profile_infer_yolo.py:94-150, without the checksums."""
    n_top = int(cfg.INFER_YOLO_TOP_N or 0)
    k_cls = int(cfg.INFER_YOLO_PER_CLASS_K or 0)
    nms_t = float(cfg.NMS_THRESHOLD)
    n_grid = cfg.GRID_H * cfg.GRID_W * cfg.N_BOX

    def upto_decode(images):
        grid, _ = det.trunk(images)
        grid = grid.astype(jnp.float32)
        boxes = decode_yolo_proposals(grid, cfg.anchors_wh, cfg.GRID_H, cfg.GRID_W)
        conf = jax.nn.sigmoid(grid[..., 4])

        def per_image(g, cf):
            probs = cf[..., None] * reference_softmax(g[..., 5:])
            probs = probs * (probs > cfg.OBJ_THRESHOLD)
            return probs.reshape(-1, cfg.NUM_CLASSES)

        return boxes, jax.vmap(per_image)(grid, conf)

    def upto_select(images):
        boxes, probs = upto_decode(images)
        if k_cls and k_cls < n_grid:
            def sel(bx, p):
                top_s, top_i = jax.lax.top_k(p.T, k_cls)
                return bx[top_i], top_s
            return jax.vmap(sel)(boxes, probs)
        if n_top and n_top < n_grid:
            def sel(bx, p):
                _, idx = jax.lax.top_k(jnp.max(p, axis=-1), n_top)
                return bx[idx], p[idx]
            return jax.vmap(sel)(boxes, probs)
        return boxes, probs

    def upto_nms(images):
        bx, sc = upto_select(images)
        if k_cls and k_cls < n_grid:
            keep = jax.vmap(jax.vmap(lambda b_, s_: greedy_nms_mask(b_, s_, nms_t)))(bx, sc)
            return sc * keep.astype(sc.dtype)
        return jax.vmap(lambda b_, p_: class_aware_nms(b_, p_, nms_t))(bx, sc)

    return {"trunk": det.trunk, "+decode": upto_decode, "+select": upto_select,
            "+nms": upto_nms}


@pytest.mark.parametrize("top_n,per_class_k", [(0, 0), (4, 0), (0, 2)],
                         ids=["full_grid", "top_n", "per_class_k"])
def test_profile_infer_yolo_prefixes_match_jax(int8_setup, top_n, per_class_k):
    """Decode, each compaction and the per-class NMS against the JAX tool's
    compositions on the same int8 grid; full equals the detector's
    infer_yolo_outputs exactly."""
    jdet, det, images = int8_setup
    over = {"INFER_YOLO_TOP_N": top_n, "INFER_YOLO_PER_CLASS_K": per_class_k}
    jcfg = type("J", (JaxInt8,), over)()
    pcfg = port_int8_config(**over)
    det = quant.QuantizedDetector(det.graph, pcfg)
    want = {n: jax.device_get(fn(jnp.asarray(images)))
            for n, fn in jax_infer_stages(jdet, jcfg).items()}
    x = torch.tensor(images)
    with torch.inference_mode():
        got = {n: np_tree(fn(x)) for n, fn in profile_infer_yolo.build_stages(det, pcfg)}
        lib = np_tree(det.infer_yolo_outputs(x))
    assert list(got) == list(profile_infer_yolo.STAGE_NAMES)
    for name in ("+decode", "+select"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
    assert (got["+decode"][1] > 0).any()   # candidates reach the NMS
    np.testing.assert_allclose(got["+nms"], want["+nms"], rtol=1e-5, atol=1e-6)
    for key in lib:
        np.testing.assert_array_equal(got["full"][key], lib[key], err_msg=key)


@pytest.mark.parametrize("tool,argv", [
    ("profile_stages_416", ["--batch", "2"]),
    ("profile_infer_yolo", ["--batch", "2", "--top-n", "4"]),
    ("profile_infer_yolo", ["--batch", "2", "--trace-only"]),
    ("profile_infer_yolo", ["--batch", "2", "--end-to-end-only", "--per-class-k", "2"]),
], ids=["stages_416", "infer_yolo", "trace_only", "end_to_end_only"])
def test_int8_profilers_print_the_jax_rows(tool, argv, capsys, monkeypatch):
    """main() of each tool on a TinyConfig-sized CocoStyleConfig (the tool's
    config, its widths cut): the JAX tool's keys (read from its json.dumps
    calls), timings finite and > 0."""
    from mask_yolo_tpu_torch.config import CocoStyleConfig

    tiny = type("C", (CocoStyleConfig,), {k: v for k, v in vars(TinyConfig).items()
                                          if k.isupper() and k not in ("NAME", "LABELS",
                                                                       "NUM_CLASSES")})
    monkeypatch.setattr(profile_stages_416, "bench_config", tiny)
    monkeypatch.setattr(profile_infer_yolo, "bench_config", tiny)
    module = {"profile_stages_416": profile_stages_416,
              "profile_infer_yolo": profile_infer_yolo}[tool]
    rows = module.main([*argv, "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
    if "--trace-only" in argv:
        assert rows == [{"stage": n, "traced": True} for n in profile_infer_yolo.STAGE_NAMES]
        return
    names = [r["stage"] for r in rows]
    if "--end-to-end-only" in argv:
        assert names == ["full"] and rows[0]["per_class_k"] == 2
        return
    jax_sets = [s for s in jax_json_keys(tool) if "traced" not in s]
    assert_rows_carry_jax_keys(rows, jax_sets)
    assert names == list(module.STAGE_NAMES)
    for a, b in zip(rows, rows[1:]):
        assert b["delta_us"] == pytest.approx(b["us_per_img"] - a["us_per_img"])
