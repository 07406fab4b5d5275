"""The port's float detect slice vs the JAX package at TinyConfig size, f32:
the trunk, the mask branch, detect_from_callables on the same trunk
outputs, the whole detect_outputs, MaskYOLO, and the batching executor.

Weights come from flax `MaskYoloNet.init` with non-degenerate BatchNorm
statistics and a scaled `mask_out`, so activations and masks spread (at
plain init every mask probability sits within 1e-4 of 0.5, where a wrong
deconv orientation cannot show)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu import pipelines as jpipelines
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet
from mask_yolo_tpu_torch import MaskYOLO, pipelines, quant
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.models import network as torch_network
from mask_yolo_tpu_torch.serve import BatchingExecutor

torch.set_num_threads(2)

PortTiny = type("PortTiny", (Config,),
                {k: v for k, v in vars(TinyConfig).items() if k.isupper()})


def _spread(variables, rng):
    """Random BN statistics and affine, and mask_out scaled 8×, on top of
    the flax init."""
    v = jax.tree_util.tree_map(np.array, jax.device_get(variables))

    def visit(params, stats):
        for name, sub in params.items():
            if "scale" in sub:                    # a BatchNorm
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
def slice_setup():
    rng = np.random.RandomState(7)
    jcfg = TinyConfig()
    net = JaxNet(num_classes=jcfg.NUM_CLASSES, n_box=jcfg.N_BOX,
                 top_feature_map_depth=jcfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=jcfg.MASK_POOL_SIZE)
    variables = _spread(net.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, *jcfg.IMAGE_SHAPE)),
                                 jnp.zeros((1, 4, 4)), train=False), rng)
    model = MaskYOLO("inference", PortTiny(), seed=0, device="cpu")
    model.load_jax_variables(variables)
    images = (rng.rand(3, *jcfg.IMAGE_SHAPE) * 255).astype(np.uint8)
    return jcfg, net, variables, model, images


def _rel_close(got, want, tol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def test_trunk_matches_jax(slice_setup):
    """Grid and fmap after 30 f32 conv layers; summation order differs
    between XLA and oneDNN: 1e-4 of the output scale."""
    _, net, variables, model, images = slice_setup
    x = images.astype(np.float32) / 255.0
    jgrid, jfmap = net.apply(variables, jnp.asarray(x), method=net.trunk)
    with torch.inference_mode():
        grid, fmap = model.net.trunk(torch.tensor(x))
    assert grid.dtype == torch.float32 and fmap.shape == jfmap.shape
    assert np.asarray(jgrid).std() > 0.1     # non-degenerate
    _rel_close(grid.numpy(), np.asarray(jgrid), 1e-4)
    _rel_close(fmap.numpy(), np.asarray(jfmap), 1e-4)


def test_mask_branch_matches_jax(slice_setup, rng):
    """Sigmoid masks from a random fmap; the masks must spread far beyond
    0.5 ± 1e-4, and agree to 1e-4 (f32 conv stack, sigmoid slope <= 1/4)."""
    jcfg, net, variables, model, _ = slice_setup
    fmap = rng.randn(2, 8, 8, jcfg.TOP_FEATURE_MAP_DEPTH).astype(np.float32)
    rois = np.stack([rng.uniform(0, 0.4, (2, 5)), rng.uniform(0, 0.4, (2, 5)),
                     rng.uniform(0.5, 1.0, (2, 5)), rng.uniform(0.5, 1.0, (2, 5))],
                    axis=-1).astype(np.float32)
    want = np.asarray(net.apply(variables, jnp.asarray(rois), jnp.asarray(fmap),
                                method=net.mask_branch))
    with torch.inference_mode():
        got = model.net.mask_branch(torch.tensor(rois), torch.tensor(fmap)).numpy()
    assert got.shape == want.shape == (2, 5, 8, 8, jcfg.NUM_CLASSES)
    assert np.abs(want - 0.5).mean() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _compare_detections(got, want, mask_agree):
    """Boolean outputs identical; float outputs to 1e-5 (decode's exp and
    sigmoid may differ by an ULP between XLA and torch); masks agree on at
    least `mask_agree` of pixels (bilinear paste then a 0.5 threshold)."""
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-5, atol=1e-4)
    assert got["masks"].shape == want["masks"].shape
    assert np.mean(got["masks"] == want["masks"]) >= mask_agree


def _np(out):
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("mask_top_k", [0, 2])
def test_detect_from_callables_on_jax_trunk_outputs(slice_setup, mask_top_k):
    """Both packages' detect_from_callables get the JAX trunk's (grid,
    fmap); only the post-trunk pipeline differs. MASK_TOP_K=2 (< K=4)
    exercises the valid-first re-sort and the empty trailing slots."""
    jcfg, net, variables, model, images = slice_setup
    jcfg = type("J", (TinyConfig,), {"MASK_TOP_K": mask_top_k})()
    pcfg = type("P", (PortTiny,), {"MASK_TOP_K": mask_top_k})()
    x = jnp.asarray(images.astype(np.float32) / 255.0)
    grid, fmap = net.apply(variables, x, method=net.trunk)
    want = jax.device_get(jpipelines.detect_from_callables(
        lambda _: (grid, fmap),
        lambda r, f: net.apply(variables, r, f, method=net.mask_branch), x, jcfg))
    with torch.inference_mode():
        got = pipelines.detect_from_callables(
            lambda _: (torch.tensor(np.asarray(grid)), torch.tensor(np.asarray(fmap))),
            model.net.mask_branch, torch.tensor(np.asarray(x)), pcfg)
    got = _np(got)
    assert got["valid"].any() and got["masks"].any()
    _compare_detections(got, want, 0.999)


def test_detect_outputs_matches_jax(slice_setup):
    """The whole slice from uint8 images, each package running its own
    trunk: trunk differences (1e-4 relative) may move a score's last digits,
    so scores and boxes get 1e-4; classes and valid stay identical."""
    jcfg, net, variables, model, images = slice_setup
    want = jax.device_get(jpipelines.detect_outputs(net, variables,
                                                    jnp.asarray(images), jcfg))
    got = _np(model.detect_batch(images))
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-2)
    assert np.mean(got["masks"] == want["masks"]) >= 0.999
    assert got["masks"].dtype == bool and got["classes"].dtype == np.int32


def test_detect_single_image(slice_setup):
    _, _, _, model, images = slice_setup
    batch = _np(model.detect_batch(images[:1]))
    res = model.detect(images[0], cs_threshold=0.0, display=False)[0]
    n = int(batch["valid"][0].sum())
    assert res["bboxes"].shape == (n, 4)
    assert res["full_masks"].shape == (*PortTiny.IMAGE_SHAPE[:2], n)
    with pytest.raises(ValueError):
        model.detect(images[0].astype(np.float32))


def test_model_defaults_to_the_card(monkeypatch):
    """Without `device` the entry points ask for the card: with no CUDA
    device they raise, and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaskYOLO("inference", PortTiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant.QuantizedDetector.from_variables({}, PortTiny(), np.zeros((1, 64, 64, 3)))


def test_model_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaskYOLO("inference", PortTiny(), device="cuda")
    # a bf16 training model holds f32 masters and computes in bf16
    bf16 = MaskYOLO("training", type("Bf16", (PortTiny,), {"COMPUTE_DTYPE": "bfloat16"})(),
                    device="cpu").net
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}
    assert bf16.backbone.conv1.conv.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        MaskYOLO("serving", PortTiny(), device="cpu")
    # the ResNet-50 + FPN backbone builds (tests/test_torch_fpn.py); an
    # unknown one raises
    fpn = torch_network.MaskYoloNet(3, 2, backbone="resnet50_fpn")
    assert fpn.backbone.out_channels == 512 and fpn.pick_trunk() == fpn.trunk_pyramid
    with pytest.raises(ValueError, match="unknown backbone"):
        torch_network.MaskYoloNet(3, 2, backbone="vgg16")


def test_executor_answers_requests(slice_setup):
    _, _, _, model, images = slice_setup
    cfg = type("Serve", (PortTiny,), {"BATCH_SIZE": 2})()
    ex = BatchingExecutor(model, cfg, max_delay_s=0.05, score_threshold=0.0)
    try:
        futs = [ex.submit(im, include_masks=i == 0) for i, im in enumerate(images)]
        results = [f.result(timeout=60) for f in futs]
    finally:
        ex.shutdown()
    assert ex.stats["requests"] == 3 and ex.stats["batches"] >= 2
    direct = _np(model.detect_batch(images[:1]))
    dets = results[0]["detections"]
    assert len(dets) == int(direct["valid"][0].sum())
    assert "mask_rle" in dets[0] and "mask_rle" not in results[1]["detections"][0]
    assert dets[0]["score"] == pytest.approx(float(direct["scores"][0, 0]), abs=1e-6)


def test_http_server_answers(slice_setup):
    import io
    import json
    import urllib.request

    from mask_yolo_tpu_torch.serve import InferenceServer, rle_to_mask

    _, _, _, model, images = slice_setup
    ex = BatchingExecutor(model, PortTiny(), max_delay_s=0.01, score_threshold=0.0)
    server = InferenceServer(ex).start()
    try:
        buf = io.BytesIO()
        np.save(buf, images[0])
        req = urllib.request.Request(f"http://{server.host}:{server.port}/detect",
                                     data=buf.getvalue(),
                                     headers={"X-Include-Masks": "1"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        with urllib.request.urlopen(f"http://{server.host}:{server.port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        server.stop()
        ex.shutdown()
    direct = _np(model.detect_batch(images[:1]))
    det = body["detections"][0]
    assert len(body["detections"]) == int(direct["valid"][0].sum())
    np.testing.assert_array_equal(rle_to_mask(det["mask_rle"], det["mask_shape"]),
                                  direct["masks"][0, 0])
    assert health["ok"] and health["stats"]["requests"] == 1
