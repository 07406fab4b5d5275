"""The plain versions of the port's int8 kernels vs the JAX package: K1
(ops/ds_block.py) against the chained int8 pair and the Pallas kernel in
interpret mode, K3 (ops/mask_fused.py) against the Pallas kernel in
interpret mode and the chained int8 mask path. On these CPU tensors the
wrappers run the plain versions; the CUDA kernels are held against them on
the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_yolo_tpu import quant as jquant
from mask_yolo_tpu.ops import pallas_ds, pallas_mask
from mask_yolo_tpu_torch import quant, weights
from mask_yolo_tpu_torch.ops import ds_block, mask_fused
from test_torch_quant import JaxQ, PortQ, spread_variables

torch.set_num_threads(2)


def _make_pair(rng, c, o, s_in=0.011, a_pw=0.017):
    """A quantized JAX (dw, pw) Layer pair with random folded weights."""
    dw = jquant.Layer("dw", "dw", rng.randn(3, 3, 1, c).astype(np.float32) * 0.4,
                      rng.randn(c).astype(np.float32) * 0.2, (1, 1), "relu6",
                      groups=c, quantize=True)
    pw = jquant.Layer("pw", "conv", rng.randn(1, 1, c, o).astype(np.float32) * 0.3,
                      rng.randn(o).astype(np.float32) * 0.2, (1, 1), "relu6")
    dw.a_scale, pw.a_scale = s_in, a_pw
    jquant.quantize_weights({"t": [dw, pw]})
    return dw, pw


@pytest.mark.parametrize("s_out", [0.05, 0.0])
@pytest.mark.parametrize("shape", [(2, 8, 12, 8, 16), (1, 5, 7, 32, 48)],
                         ids=["8x12_c8", "5x7_c32"])
def test_ds_block_plain_matches_jax(rng, s_out, shape):
    """(d) K1's plain version == JAX's chained int8 pair, bit for bit (f32
    output: the same f32 ops, so also exact); within 1 LSB of the Pallas
    kernel, whose requantize takes its inverse scale in f64."""
    b, h, w, c, o = shape
    dw, pw = _make_pair(rng, c, o)
    x_q = rng.randint(-127, 128, size=(b, h, w, c)).astype(np.int8)
    x1, s1 = jquant.run_layer_int8(dw, jnp.asarray(x_q), dw.a_scale, out_scale=pw.a_scale)
    chained = np.asarray(jquant.run_layer_int8(pw, x1, s1,
                                               out_scale=s_out if s_out else None)[0])
    packed = pallas_ds.pack_ds_pair(dw, pw, dw.a_scale)
    for mine, theirs in zip(ds_block.pack_ds_pair(dw, pw, dw.a_scale), packed):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    pallas = np.asarray(pallas_ds.fused_ds_block(
        *map(jnp.asarray, (x_q, *packed)), a_pw=float(pw.a_scale), s_out=float(s_out),
        interpret=True))

    launches = ds_block.fused_ds_block.launches
    got = ds_block.fused_ds_block(*map(torch.tensor, (x_q, *packed)), a_pw=pw.a_scale,
                                  s_out=s_out).numpy()
    assert ds_block.fused_ds_block.launches == launches   # CPU runs the plain version
    assert got.dtype == (np.int8 if s_out else np.float32)
    np.testing.assert_array_equal(got, chained)
    if s_out:
        assert np.abs(got.astype(np.int32) - pallas.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


def test_ds_block_checks_inputs(rng):
    dw, pw = _make_pair(rng, 8, 16)
    args = list(map(torch.tensor, (rng.randint(-5, 5, (1, 4, 4, 8)).astype(np.int8),
                                   *pallas_ds.pack_ds_pair(dw, pw, dw.a_scale))))
    with pytest.raises(TypeError):
        ds_block.fused_ds_block(args[0].float(), *args[1:], a_pw=0.1)
    with pytest.raises(ValueError, match="wpw"):
        ds_block.fused_ds_block(*args[:3], args[3][:4], args[4], a_pw=0.1)
    with pytest.raises(ValueError, match="a_pw"):
        ds_block.fused_ds_block(*args, a_pw=0.0)


@pytest.fixture(scope="module")
def mask_setup():
    """A calibrated JAX detector on the spread tree (deconv pre-flipped),
    the same graph in the port, and both packages' packed K3 weights."""
    v, vf, _ = spread_variables()
    rng = np.random.RandomState(21)
    calib = rng.rand(2, *JaxQ.IMAGE_SHAPE).astype(np.float32)
    jdet = jquant.QuantizedDetector.from_variables(vf, JaxQ(), calib)
    _, fmap = jax.jit(lambda im: jdet.trunk(im, fused_ds=False))(jnp.asarray(calib))
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), PortQ())
    jw = pallas_mask.pack_mask_weights(jdet.graph, JaxQ.NUM_CLASSES)
    pw = mask_fused.pack_mask_weights(det.graph, JaxQ.NUM_CLASSES)
    return jdet, det, np.asarray(fmap), jw, pw


def _boxes(rng, b, k):
    lo = rng.uniform(0.0, 0.5, size=(b, k, 2))
    return np.concatenate([lo, lo + rng.uniform(0.1, 0.45, size=(b, k, 2))],
                          axis=-1).astype(np.float32)


def _close(got, ref):
    """The bounds of tests/test_pallas_mask.py: one int8 step flipped by a
    rounding ripples, so compare distributions."""
    err = np.abs(got - ref)
    assert err.mean() < 5e-3, err.mean()
    assert (err > 0.05).mean() < 5e-3, (err > 0.05).mean()
    decided = np.abs(ref - 0.5) > 0.05
    assert decided.mean() > 0.2
    agree = ((got >= 0.5) == (ref >= 0.5))[decided].mean()
    assert agree > 0.995, agree


def test_mask_weights_pack_like_jax(mask_setup):
    """The same operands as the JAX package packs (wo as bf16 values; the
    port keeps the six activation scales without the TPU's padding)."""
    _, _, _, jw, pw = mask_setup
    assert jw.keys() == pw.keys()
    for key in jw:
        want = np.asarray(jnp.asarray(jw[key], jnp.float32)).reshape(-1)
        np.testing.assert_array_equal(np.asarray(pw[key], np.float32).reshape(-1),
                                      want[:6] if key == "asc" else want, err_msg=key)


def test_mask_plain_matches_pallas_and_chained(mask_setup, rng):
    """(e) K3's plain version against the Pallas kernel in interpret mode
    and against the chained int8 mask path plus a one-hot select."""
    jdet, det, fmap, jw, pw = mask_setup
    b, k = fmap.shape[0], 7
    boxes = _boxes(rng, b, k)
    classes = rng.randint(0, JaxQ.NUM_CLASSES, size=(b, k)).astype(np.int32)
    launches = mask_fused.fused_mask_branch.launches
    got = mask_fused.fused_mask_branch(
        torch.tensor(fmap), torch.tensor(boxes), torch.tensor(classes),
        mask_fused.weights_to(pw, "cpu"), pool=JaxQ.MASK_POOL_SIZE,
        num_classes=JaxQ.NUM_CLASSES).numpy()
    assert mask_fused.fused_mask_branch.launches == launches
    pallas = np.asarray(pallas_mask.fused_mask_branch(
        jnp.asarray(fmap), jnp.asarray(boxes), jnp.asarray(classes), jw,
        pool=JaxQ.MASK_POOL_SIZE, num_classes=JaxQ.NUM_CLASSES, interpret=True, k_block=3))
    assert got.shape == pallas.shape == (b, k, 2 * JaxQ.MASK_POOL_SIZE, 2 * JaxQ.MASK_POOL_SIZE)
    _close(got, pallas)
    with torch.inference_mode():
        full = det.mask_branch(torch.tensor(boxes), torch.tensor(fmap)).numpy()
    chained = np.take_along_axis(full, classes[:, :, None, None, None], axis=-1)[..., 0]
    _close(got, chained)


def test_mask_plain_off_map_boxes(mask_setup):
    """(e) Boxes wholly or partly off the map crop zeros there and still
    give finite masks in [0, 1]."""
    _, det, fmap, _, pw = mask_setup
    boxes = np.asarray([[[2.0, 2.0, 3.0, 3.0], [-0.5, -0.3, 0.5, 0.6]]] * fmap.shape[0],
                       np.float32)
    classes = np.zeros(boxes.shape[:2], np.int32)
    out = det.fused_mask(torch.tensor(boxes), torch.tensor(fmap), torch.tensor(classes))
    out = out.numpy()
    assert np.all(np.isfinite(out)) and np.all((out >= 0) & (out <= 1))


def test_mask_checks_inputs(mask_setup):
    _, _, fmap, _, pw = mask_setup
    w = mask_fused.weights_to(pw, "cpu")
    f, bx = torch.tensor(fmap), torch.zeros((fmap.shape[0], 2, 4))
    cl = torch.zeros((fmap.shape[0], 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        mask_fused.fused_mask_branch(f, bx, cl[:, :1], w, 4, 4)
    with pytest.raises(TypeError):
        mask_fused.fused_mask_branch(f, bx.double(), cl, w, 4, 4)
    with pytest.raises(ValueError, match="num_classes"):
        mask_fused.fused_mask_branch(f, bx, cl, w, 4, 5)


def test_mask_pack_refuses_vector_scales(mask_setup):
    _, det, *_ = mask_setup
    graph = {"mask": [quant.Layer(**{f: getattr(l, f) for f in weights._LAYER_FIELDS})
                      for l in det.graph["mask"]]}
    graph["mask"][2].a_scale = np.full(256, 0.01, np.float32)
    with pytest.raises(NotImplementedError, match="per-tensor"):
        mask_fused.pack_mask_weights(graph, JaxQ.NUM_CLASSES)
