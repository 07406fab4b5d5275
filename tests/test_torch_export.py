"""The port's export artifact (mask_yolo_tpu_torch/export.py) on the CPU, the
JAX package's export tests case for case (tests/test_export.py), plus what
only the port has: the kernels as `torch.library` custom ops in the program,
a load in a process that is given nothing but the artifact, and the port's
artifact against the JAX package's from the same weights.

Weights: flax `MaskYoloNet.init` at TinyConfig with spread BatchNorm
statistics and `mask_out` scaled 8× (as tests/test_torch_slice.py), carried
across by `weights.from_jax_variables`. On the CPU every op runs its plain
version, and the program runs the live path's ops, so artifact and live path
agree bit for bit. Against the JAX package's artifact, the port's parity
bounds: classes and valid equal, boxes within 1e-5 of the image size, scores
within 1e-5, masks equal on at least 99.9 % of pixels (the two trunks differ
by 1e-4 of their scale, tests/test_torch_slice.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet
from mask_yolo_tpu_torch import MaskYOLO
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.export import ExportedDetector, custom_op_counts, export_detect_fn
from mask_yolo_tpu_torch.serve import BatchingExecutor

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class JaxCfg(TinyConfig):
    BATCH_SIZE = 2
    OBJ_THRESHOLD = 0.0   # untrained net: keep everything


PortCfg = type("PortCfg", (Config,), {k: getattr(JaxCfg, k) for k in dir(JaxCfg)
                                      if k.isupper()})


class PortInt8Cfg(PortCfg):
    TOP_FEATURE_MAP_DEPTH = 32
    QUANT_DW_INT8 = True
    QUANT_FUSED_DS = True
    QUANT_FUSED_MASK = True


def _spread(variables, rng):
    """Random BatchNorm statistics and affine and mask_out ×8 on a flax init."""
    v = jax.tree_util.tree_map(np.array, jax.device_get(variables))

    def visit(params, stats):
        for name, sub in params.items():
            if "scale" in sub:
                c = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.8, 1.6, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.3, 1.0, c).astype(np.float32)
            elif "kernel" not in sub:
                visit(sub, stats.get(name, {}))

    visit(v["params"], v["batch_stats"])
    v["params"]["mask"]["mask_out"]["kernel"] *= 8.0
    return v


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(7)
    cfg = JaxCfg()
    net = JaxNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                 top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=cfg.MASK_POOL_SIZE)
    variables = _spread(net.init(jax.random.PRNGKey(0), jnp.zeros((1, *cfg.IMAGE_SHAPE)),
                                 jnp.zeros((1, 4, 4)), train=False), rng)
    model = MaskYOLO("inference", PortCfg(), seed=0, device="cpu")
    model.load_jax_variables(variables)
    return model, variables


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    model, _ = setup
    path = tmp_path_factory.mktemp("export") / "detect.pt2"
    header = model.export_model(path)
    return path, header


def _images(rng, b):
    return (rng.rand(b, *PortCfg.IMAGE_SHAPE) * 255).astype(np.uint8)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_symbolic_batch_round_trip(setup, artifact, rng):
    model, _ = setup
    path, header = artifact
    assert header["batch_size"] is None
    assert header["image_shape"] == list(PortCfg.IMAGE_SHAPE)
    assert header["model"] == "mask_yolo_tpu_torch.detect" and "torch_version" in header
    det = ExportedDetector.load(path)
    # one symbolic-batch artifact serves other batch sizes than the one it
    # was traced on, each bit-equal to the live path
    for b in (1, 3):
        imgs = _images(rng, b)
        _assert_equal(det.detect_batch(imgs), model.detect_batch(imgs))


def test_fixed_batch_artifact_rejects_other_batches(setup, tmp_path, rng):
    model, _ = setup
    path = tmp_path / "detect_b2.pt2"
    header = model.export_model(path, batch_size=2)
    assert header["batch_size"] == 2
    det = ExportedDetector.load(path)
    imgs = _images(rng, 2)
    out = det.detect_batch(imgs)
    assert tuple(out["boxes"].shape) == (2, PortCfg.DETECTION_MAX_INSTANCES, 4)
    with pytest.raises(ValueError, match="batch_size=2"):
        det.detect_batch(imgs[:1])


def test_float_input_is_quantized_to_wire_dtype(artifact, rng):
    det = ExportedDetector.load(artifact[0])
    u8 = _images(rng, 2)
    _assert_equal(det.detect_batch(u8.astype(np.float32) / 255.0), det.detect_batch(u8))


def test_float32_artifact_normalizes_integer_input(setup, tmp_path, rng):
    model, _ = setup
    path = tmp_path / "detect_f32.pt2"
    assert model.export_model(path, input_dtype="float32")["input_dtype"] == "float32"
    det = ExportedDetector.load(path)
    u8 = _images(rng, 2)
    _assert_equal(det.detect_batch(u8), det.detect_batch(u8.astype(np.float32) / 255.0))
    _assert_equal(det.detect_batch(u8), model.detect_batch(u8))


def test_platforms_list_where_the_artifact_loads(setup, tmp_path, rng):
    """Traced on the CPU with platforms ["cpu", "cuda"]: the header lists
    both and the CPU load matches live; an artifact for the CPU alone
    refuses a load onto the card."""
    model, _ = setup
    path = tmp_path / "detect_multi.pt2"
    header = model.export_model(path, platforms=["cpu", "cuda"])
    assert sorted(header["platforms"]) == ["cpu", "cuda"] and header["traced_on"] == "cpu"
    imgs = _images(rng, 2)
    _assert_equal(ExportedDetector.load(path, device="cpu").detect_batch(imgs),
                  model.detect_batch(imgs))
    model.export_model(tmp_path / "cpu_only.pt2")
    with pytest.raises(ValueError, match="exported for"):
        ExportedDetector.load(tmp_path / "cpu_only.pt2", device="cuda")
    with pytest.raises(ValueError, match="platforms"):
        model.export_model(tmp_path / "bad.pt2", platforms=["tpu"])


def test_export_fn_traces_on_the_card_unless_asked():
    """Given neither a net nor a device, export_detect_fn traces on the card,
    and without one it refuses rather than tracing on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_detect_fn(lambda images: {"images": images}, PortCfg())


def test_int8_path_exports_after_quantize(setup, tmp_path, rng):
    """After quantize() the artifact is the active int8 pipeline, bit-equal
    to the live int8 path, with K1 and K3 in its graph as custom ops."""
    _, variables = setup
    model = MaskYOLO("inference", PortInt8Cfg(), seed=0, device="cpu")
    jv = jax.tree_util.tree_map(np.array, variables)
    cf = PortInt8Cfg.TOP_FEATURE_MAP_DEPTH   # K3's fmap depth: a wider neck
    r = np.random.RandomState(3)
    jv["params"]["feature_map"]["kernel"] = r.normal(0, 0.05, (3, 3, 512, cf)).astype(np.float32)
    jv["params"]["feature_map"]["bias"] = np.zeros(cf, np.float32)
    jv["params"]["mask"]["mask_conv1"]["kernel"] = r.normal(
        0, 0.05, (3, 3, cf, 256)).astype(np.float32)
    model.load_jax_variables(jv)
    model.quantize(rng.rand(2, *PortCfg.IMAGE_SHAPE).astype(np.float32))
    path = tmp_path / "detect_int8.pt2"
    assert model.export_model(path)["compute_path"] == "int8"
    det = ExportedDetector.load(path)
    assert custom_op_counts(det.program) == {"fused_ds_block": 10, "fused_mask_branch": 1}
    imgs = _images(rng, 3)
    _assert_equal(det.detect_batch(imgs), model.detect_batch(imgs.astype(np.float32) / 255.0))


def test_float_graph_holds_the_crop_op(artifact):
    """The float program calls K2 as the custom op (no plain-crop aten ops
    in its place)."""
    program = ExportedDetector.load(artifact[0]).program
    assert custom_op_counts(program) == {"crop_rois": 1}


@pytest.mark.parametrize("op", ["crop_rois", "crop_rois_backward", "fused_ds_block",
                                "fused_mask_branch"])
def test_custom_ops_have_cpu_and_cuda_kernels_only(op):
    """Each op: a CPU kernel (the plain version), a CUDA kernel (the hand
    kernel's launch), a fake for tracing, and no device-generic kernel."""
    name = f"mask_yolo_tpu_torch::{op}"
    has = lambda key: torch._C._dispatch_has_kernel_for_dispatch_key(name, key)  # noqa: E731
    assert has("CPU") and has("CUDA")
    assert not has("CompositeExplicitAutograd") and not has("CompositeImplicitAutograd")
    assert has("Meta")   # the fake
    if op == "crop_rois":
        assert has("Autograd")


def test_load_rejects_foreign_files(setup, tmp_path):
    p = tmp_path / "not_an_export.bin"
    p.write_bytes(b"PNG....definitely not a detect artifact")
    with pytest.raises(ValueError, match="bad magic"):
        ExportedDetector.load(p)
    # a file of the JAX package's own format
    from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO

    _, variables = setup
    jmodel = JaxMaskYOLO(mode="inference", config=JaxCfg())
    jmodel.params, jmodel.batch_stats = variables["params"], variables["batch_stats"]
    jmodel.export_model(tmp_path / "jax.mytpu")
    with pytest.raises(ValueError, match="bad magic"):
        ExportedDetector.load(tmp_path / "jax.mytpu")


def test_port_artifact_matches_jax_artifact(setup, artifact, tmp_path, rng):
    """The port's artifact and the JAX package's from the same weights, on the
    same uint8 images, within the port's parity bounds."""
    from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO
    from mask_yolo_tpu.export import ExportedDetector as JaxExported

    _, variables = setup
    jmodel = JaxMaskYOLO(mode="inference", config=JaxCfg())
    jmodel.params, jmodel.batch_stats = variables["params"], variables["batch_stats"]
    jmodel.export_model(tmp_path / "jax.mytpu")
    imgs = _images(rng, 3)
    want = {k: np.asarray(v) for k, v in JaxExported.load(
        tmp_path / "jax.mytpu").detect_batch(imgs).items()}
    got = {k: v.numpy() for k, v in ExportedDetector.load(artifact[0]).detect_batch(
        imgs).items()}
    assert got["valid"].any() and got["masks"].any()
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
    h, w = PortCfg.IMAGE_SHAPE[:2]
    scale = np.array([w, h, w, h], np.float32)
    np.testing.assert_allclose(got["boxes"] / scale, want["boxes"] / scale, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    assert np.mean(got["masks"] == want["masks"]) >= 0.999


def test_artifact_serves_in_a_process_given_nothing_else(setup, artifact, tmp_path, rng):
    """A fresh process with the artifact and images alone (no config, no
    weights, no JAX) reproduces the live path."""
    model, _ = setup
    imgs = _images(rng, 3)
    np.save(tmp_path / "images.npy", imgs)
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from mask_yolo_tpu_torch.export import ExportedDetector\n"
        "det = ExportedDetector.load(sys.argv[1])\n"
        "out = det.detect_batch(np.load(sys.argv[2]))\n"
        "assert 'jax' not in sys.modules\n"
        "np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})\n")
    subprocess.run([sys.executable, "-c", code, str(artifact[0]), str(tmp_path / "images.npy"),
                    str(tmp_path / "out.npz")], check=True, timeout=300,
                   env=dict(os.environ, OMP_NUM_THREADS="2"))
    got = np.load(tmp_path / "out.npz")
    for k, v in model.detect_batch(imgs).items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_exported_detector_serves(setup, tmp_path, rng):
    """ExportedDetector behind serve.BatchingExecutor, from the header's
    config shim alone."""
    model, _ = setup
    path = tmp_path / "detect.pt2"
    model.export_model(path, batch_size=PortCfg.BATCH_SIZE)
    det = ExportedDetector.load(path)
    shim = det.serve_config()
    assert shim.IMAGE_SHAPE == list(PortCfg.IMAGE_SHAPE)
    assert shim.BATCH_SIZE == PortCfg.BATCH_SIZE
    assert shim.LABELS == list(PortCfg.LABELS)
    with pytest.raises(ValueError, match="pins batch_size"):
        det.serve_config(batch_size=PortCfg.BATCH_SIZE + 1)
    ex = BatchingExecutor(det, shim, max_delay_s=0.2, score_threshold=0.0)
    try:
        imgs = _images(rng, 3)
        results = [f.result(timeout=120) for f in [ex.submit(im) for im in imgs]]
        direct = model.detect_batch(imgs[:PortCfg.BATCH_SIZE])
        assert len(results[0]["detections"]) == int(direct["valid"][0].sum())
    finally:
        ex.shutdown()
