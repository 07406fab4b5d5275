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
    mine = ds_block.pack_ds_pair(dw, pw, dw.a_scale)
    for name, ours, theirs in zip(("kdw", "dwsb", "wpw", "pwsb"), mine, packed):
        # the port packs wpw K-contiguous, [O, C]: the transpose of JAX's [C, O]
        want = np.asarray(theirs).T if name == "wpw" else np.asarray(theirs)
        np.testing.assert_array_equal(ours, want, err_msg=name)
    pallas = np.asarray(pallas_ds.fused_ds_block(
        *map(jnp.asarray, (x_q, *packed)), a_pw=float(pw.a_scale), s_out=float(s_out),
        interpret=True))

    launches = ds_block.fused_ds_block.launches
    got = ds_block.fused_ds_block(*map(torch.tensor, (x_q, *mine)), a_pw=pw.a_scale,
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
                                   *ds_block.pack_ds_pair(dw, pw, dw.a_scale))))
    with pytest.raises(TypeError):
        ds_block.fused_ds_block(args[0].float(), *args[1:], a_pw=0.1)
    with pytest.raises(ValueError, match="wpw"):
        ds_block.fused_ds_block(*args[:3], args[3][:, :4], args[4], a_pw=0.1)
    with pytest.raises(ValueError, match="a_pw"):
        ds_block.fused_ds_block(*args, a_pw=0.0)


@pytest.mark.parametrize("bad", ["jax_layout", "dtype", "non_contiguous"])
def test_ds_block_refuses_a_bad_packed_wpw(rng, bad):
    """wpw must be the packed [O, C] int8 array: the JAX package's [C, O],
    another dtype or a strided view of the right shape raise."""
    dw, pw = _make_pair(rng, 8, 16)
    x_q, kdw, dwsb, wpw, pwsb = map(torch.tensor, (
        rng.randint(-5, 5, (1, 4, 4, 8)).astype(np.int8), *ds_block.pack_ds_pair(dw, pw, 0.01)))
    wpw = {"jax_layout": wpw.t().contiguous(), "dtype": wpw.int(),
           "non_contiguous": torch.zeros((8, 16), dtype=torch.int8).t()}[bad]
    with pytest.raises(ValueError, match="wpw"):
        ds_block.fused_ds_block(x_q, kdw, dwsb, wpw, pwsb, a_pw=0.1)


@pytest.mark.parametrize("c, o", [(8, 16), (32, 64), (1024, 1024)],
                         ids=["tiny", "shapes_first", "shapes_last"])
def test_ds_pack_unpacks_to_the_plain_operands(rng, c, o):
    """pack_ds_pair's wpw is K-contiguous [O, C]; its transpose is exactly
    the pointwise layer's int8 kernel as the JAX package packs it."""
    dw, pw = _make_pair(rng, c, o)
    kdw, dwsb, wpw, pwsb = ds_block.pack_ds_pair(dw, pw, dw.a_scale)
    assert wpw.shape == (o, c) and wpw.dtype == np.int8 and wpw.flags.c_contiguous
    np.testing.assert_array_equal(wpw.T, np.asarray(pw.w_q).reshape(c, o))
    np.testing.assert_array_equal(wpw.T, np.asarray(pallas_ds.pack_ds_pair(dw, pw, dw.a_scale)[2]))


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
    """The same operands as the JAX package packs, once the swizzled
    K-contiguous GEMM weights are unpacked (wo as bf16 values; the port
    keeps the six activation scales without the TPU's padding)."""
    _, _, fmap, jw, pw = mask_setup
    assert jw.keys() == pw.keys()
    plain = mask_fused.unpack_mask_weights(mask_fused.weights_to(pw, "cpu"), fmap.shape[-1])
    for key in jw:
        want = np.asarray(jnp.asarray(jw[key], jnp.float32)).reshape(-1)
        got = plain[key].numpy() if key in plain else pw[key]
        np.testing.assert_array_equal(np.asarray(got, np.float32).reshape(-1),
                                      want[:6] if key == "asc" else want, err_msg=key)


def _mask_graph(rng, cf, co, nc):
    """Six random quantized mask layers of the given widths."""
    def layer(name, shape):
        return quant.Layer(name, "conv", rng.standard_normal(shape).astype(np.float32),
                           rng.standard_normal(shape[-1]).astype(np.float32),
                           w_q=rng.integers(-127, 128, shape, dtype=np.int8),
                           w_scale=rng.uniform(0.01, 0.02, shape[-1]).astype(np.float32),
                           a_scale=0.05)
    return {"mask": [layer("mask_conv1", (3, 3, cf, co))]
            + [layer(f"mask_conv{i}", (3, 3, co, co)) for i in (2, 3, 4)]
            + [layer("mask_deconv", (1, 1, co, 4 * co)), layer("mask_out", (1, 1, 4 * co, 4 * nc))]}


@pytest.mark.parametrize("cf, co, nc", [(16, 256, 4), (16, 16, 4), (256, 256, 4),
                                        (256, 256, 81)],
                         ids=["tiny", "narrow", "shapes", "coco"])
def test_mask_pack_unpacks_to_the_plain_operands(cf, co, nc):
    """K3's packed GEMM weights are [256, 9 x (Cin rounded up to 128)] int8
    (the kernel's tile widths), chunk c of a row's 128-byte block at chunk
    c ^ (n % 8), zero in the padded channels; cut to the true widths they
    unpack to exactly the im2col matrices of the graph."""
    rng = np.random.default_rng(cf + nc)
    graph = _mask_graph(rng, cf, co, nc)
    packed = mask_fused.pack_mask_weights(graph, nc)
    layers = graph["mask"]
    want = {"w1": layers[0].w_q.reshape(9 * cf, co), "wd": layers[4].w_q.reshape(co, 4 * co)}
    want.update({f"w{i}": layers[i - 1].w_q.reshape(9 * co, co) for i in (2, 3, 4)})
    cfp = -(-cf // 128) * 128
    assert packed["w1"].shape == (256, 9 * cfp) and packed["wd"].shape == (4 * 256, 256)
    plain = mask_fused.unpack_mask_weights(mask_fused.weights_to(packed, "cpu"), cf, co)
    for key, w in want.items():
        assert packed[key].dtype == np.int8 and packed[key].flags.c_contiguous
        np.testing.assert_array_equal(plain[key].numpy(), w, err_msg=key)
    padded = mask_fused.unpack_mask_weights(mask_fused.weights_to(packed, "cpu"))
    rows = padded["w2"].numpy().T             # [N, K], the unswizzled order
    for n in (0, 5, 13, 255):
        for c in range(16):
            block, chunk = divmod(c, 8)
            at = 128 * block + 16 * (chunk ^ (n % 8))
            np.testing.assert_array_equal(packed["w2"][n, at:at + 16], rows[n, 16 * c:16 * c + 16])
    w1 = padded["w1"].numpy().reshape(9, cfp, 256)
    assert not w1[:, cf:].any() and not w1[:, :, co:].any()
    assert not padded["wd"].numpy().reshape(256, 4, 256)[co:].any()
    assert not packed["wsc"].reshape(5, 4, 256)[:, :, co:].any()
    assert not packed["bias"][:5].reshape(5, 4, 256)[:, :, co:].any()


@pytest.mark.parametrize("bad", ["unpacked_layout", "dtype", "non_contiguous", "wd_shape"])
def test_mask_wrapper_refuses_a_bad_packed_operand(mask_setup, bad):
    """The wrapper holds each packed operand to its dtype, shape and
    contiguity before anything runs."""
    _, _, fmap, _, pw = mask_setup
    w = dict(mask_fused.weights_to(pw, "cpu"))
    if bad == "unpacked_layout":
        w["w2"] = mask_fused.unpack_mask_weights(w, fmap.shape[-1])["w2"].contiguous()
    elif bad == "dtype":
        w["w3"] = w["w3"].to(torch.int16)
    elif bad == "non_contiguous":
        w["w4"] = torch.zeros(tuple(w["w4"].shape)[::-1], dtype=torch.int8).t()
    else:
        w["wd"] = w["wd"][:, :128].contiguous()
    b = fmap.shape[0]
    with pytest.raises(ValueError, match="w2|w3|w4|wd"):
        mask_fused.fused_mask_branch(torch.tensor(fmap), torch.zeros((b, 2, 4)),
                                     torch.zeros((b, 2), dtype=torch.int32), w,
                                     JaxQ.MASK_POOL_SIZE, JaxQ.NUM_CLASSES)


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


@pytest.mark.parametrize("cf, co", [(16, 16), (16, 256), (200, 64)], ids=["narrow", "tiny", "Cf200"])
def test_mask_branch_zero_padding_changes_nothing(cf, co):
    """The packed weights carry zero channels up to the kernel's tiles (Cf to
    a multiple of 128, co to 256). The plain version, which multiplies by
    the padded matrices as the kernel does, gives exactly the masks of the
    same arithmetic written at the true widths: zero int8 channels add
    nothing to an int32 product, and a padded output channel stays 0."""
    from mask_yolo_tpu_torch.ops.int8 import int_mm, quantize
    from mask_yolo_tpu_torch.ops.roi_align import crop_and_resize

    rng = np.random.default_rng(cf + co)
    nc, pool, b, k = 4, 4, 2, 5
    graph = _mask_graph(rng, cf, co, nc)
    for layer in graph["mask"]:
        layer.w_scale = (layer.w_scale / 30).astype(np.float32)    # keep activations in range
    layers = graph["mask"]
    packed = mask_fused.weights_to(mask_fused.pack_mask_weights(graph, nc), "cpu")
    fmap = torch.tensor(rng.standard_normal((b, 8, 8, cf)).astype(np.float32))
    boxes = torch.tensor(_boxes(np.random.RandomState(1), b, k))
    classes = torch.tensor(rng.integers(0, nc, (b, k)), dtype=torch.int32)
    got = mask_fused.fused_mask_branch(fmap, boxes, classes, packed, pool, nc)

    asc = [float(np.float32(l.a_scale)) for l in layers]
    x_q = quantize(crop_and_resize(fmap.bfloat16(), boxes, (pool, pool)).float()
                   .reshape(b * k * pool * pool, cf), asc[0])
    for li in range(4):
        w = torch.tensor(layers[li].w_q.reshape(-1, co))
        acc = mask_fused._conv3x3_rois(x_q, w, pool)
        y = torch.relu(acc.float() * (torch.tensor(layers[li].w_scale) * asc[li])
                       + torch.tensor(layers[li].bias))
        x_q = quantize(y, asc[li + 1])
    acc = int_mm(x_q, torch.tensor(layers[4].w_q.reshape(co, 4 * co)))
    y = torch.relu(acc.float() * (torch.tensor(layers[4].w_scale) * asc[4])
                   + torch.tensor(layers[4].bias))
    yb = quantize(y, asc[5]).to(torch.bfloat16) * torch.tensor(asc[5], dtype=torch.bfloat16)
    wo = torch.tensor(layers[5].kernel.reshape(4 * co, 4 * nc)).bfloat16().float()
    probs = torch.sigmoid(yb.float() @ wo + torch.tensor(layers[5].bias))
    probs = probs.reshape(b * k, pool * pool, 4, nc)
    sel = torch.gather(probs, -1, classes.reshape(-1).long()[:, None, None, None].expand(
        -1, pool * pool, 4, 1))[..., 0].bfloat16().float()
    want = sel.reshape(b, k, pool, pool, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(
        b, k, 2 * pool, 2 * pool)
    assert (want - 0.5).abs().mean() > 0.02        # the masks spread
    # the f32 class conv sums 4·co against 4·256 terms (the extra ones zero),
    # possibly grouped otherwise: at most one bf16 ULP (2^-8) on a few values
    diff = (got - want).abs()
    assert diff.max() <= 2.0 ** -8 and (diff > 0).float().mean() < 1e-2
    print(f"padded vs true width: {int((diff > 0).sum())} of {diff.numel()} mask values differ")
