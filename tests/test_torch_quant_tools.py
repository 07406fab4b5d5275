"""The port's int8 quality tools (mask_yolo_tpu_torch/quant.py: per-channel
activation scales, percentile calibration, QUANT_MASK_F32_LAYERS,
bias_correct, the quantization-aware finetune) vs the JAX package's, at
TinyConfig size with 4 classes on the spread tree of test_torch_quant.py
(JAX gets the tree with mask_deconv flipped beforehand, so both graphs hold
the same layers).

Where a bias-corrected graph is compared with JAX, the chained layers are
compared: the JAX package's fused kernels' packers drop bias_corr (ROADMAP
Queue 3), the port's add it (test_torch_int8_kernels.py).

Tolerances. XLA's CPU convolutions and torch's im2col products sum f32
terms in different orders, so activations agree to ~1e-6 relative: a
calibration absmax to rtol 1e-5, a percentile (interpolated between two
order statistics, each that noisy, at an index JAX computes in f32) to rtol
1e-4. A rounding that lands on the other side of .5 flips one int8 step of
one value; its effect on a mean over a few hundred positions is what sets
the bias_corr and gradient tolerances below, each stated in its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_yolo_tpu import quant as jquant
from mask_yolo_tpu_torch import MaskYOLO, quant, weights
from test_torch_quant import JaxQ, PortQ, _layers, spread_variables

torch.set_num_threads(2)


def _cfgs(**knobs):
    return type("J", (JaxQ,), knobs)(), type("P", (PortQ,), knobs)()


@pytest.fixture(scope="module")
def setup():
    v, vf, _ = spread_variables()
    calib = np.random.RandomState(3).rand(4, *JaxQ.IMAGE_SHAPE).astype(np.float32)
    return v, vf, calib


@pytest.fixture(scope="module")
def jax_per_tensor(setup):
    _, vf, calib = setup
    return jquant.QuantizedDetector.from_variables(vf, JaxQ(), calib)


def _port_graph(v, cfg, calib):
    return quant.quantize_weights(quant.calibrate(
        quant.build_layer_graph(v, cfg), cfg, torch.tensor(calib)))


def test_per_channel_scales_match_jax(setup):
    """(a) QUANT_PER_CHANNEL_ACT: every a_scale is a vector whose entries
    are within rtol 1e-5 of JAX's on at least 99 % of all channels (99.4 % here), and
    every one within 1e-5 of its own value plus 1e-5 of the layer's largest
    scale. The SmoothQuant split runs in numpy in both, on absmax vectors
    that carry the f32 summation-order noise of every layer before them: a
    channel's absmax is one value, and where that value is a small
    difference of large sums (a nearly dead channel, scale 6e-4 beside a
    layer's 5e-2) the noise is absolute, not relative: 2.9e-4 of its own
    value on one of block8/pw's 512 channels here, 5.7e-5 on one of
    feature_map's (the per-tensor scales hold rtol 1e-5,
    test_torch_quant.py). act_folded is set on the int8 layers, w_scale
    agrees to the same tolerance and w_q on at least 99.9 % of entries, never more
    than one step apart (a folded weight on a rounding boundary may land on
    the other step)."""
    v, vf, calib = setup
    jcfg, pcfg = _cfgs(QUANT_PER_CHANNEL_ACT=True)
    want = jquant.QuantizedDetector.from_variables(vf, jcfg, calib).graph
    got = _port_graph(v, pcfg, calib)
    same = total = tight = channels = 0
    for g, w in zip(_layers(got), _layers(want)):
        assert isinstance(g.a_scale, np.ndarray) and g.a_scale.dtype == np.float32, g.name
        assert g.a_scale.shape == np.asarray(w.a_scale).shape, g.name
        np.testing.assert_allclose(g.a_scale, w.a_scale, rtol=1e-5,
                                   atol=1e-5 * np.max(w.a_scale), err_msg=g.name)
        tight += int(np.isclose(g.a_scale, w.a_scale, rtol=1e-5, atol=0).sum())
        channels += g.a_scale.size
        assert g.act_folded == w.act_folded == bool(w.quantize), g.name
        if w.quantize:
            np.testing.assert_allclose(g.w_scale, np.asarray(w.w_scale), rtol=1e-5,
                                       atol=1e-5 * np.max(w.w_scale), err_msg=g.name)
            same += int((g.w_q == np.asarray(w.w_q)).sum())
            total += g.w_q.size
            assert np.abs(g.w_q.astype(np.int32) - np.asarray(w.w_q, np.int32)).max() <= 1
    assert same / total >= 0.999, same / total
    assert tight / channels >= 0.99, tight / channels
    # a storage-only (bf16) layer takes the exact per-channel absmax / 127
    out = got["mask"][-1]
    assert not out.quantize and isinstance(out.a_scale, np.ndarray) and not out.act_folded


def test_per_channel_dead_channels_take_the_median_live_scale(setup):
    """A channel whose calibration absmax is 0 gets the median live scale,
    not 1.0, which would dominate the folded kernel's absmax."""
    v, _, calib = setup
    _, pcfg = _cfgs(QUANT_PER_CHANNEL_ACT=True)
    dead = calib.copy()
    dead[..., 2] = 0.0                      # the blue channel never fires
    graph = quant.calibrate(quant.build_layer_graph(v, pcfg), pcfg, torch.tensor(dead))
    s = graph["trunk"][0].a_scale
    assert s.shape == (3,) and s[2] == np.float32(np.median(s[:2]))


def test_percentile_scales_match_jax(setup):
    """(b) QUANT_CALIB_PCT = 99.9: every a_scale a Python float within rtol
    1e-4 of JAX's jnp.quantile (module docstring), never above the absmax
    scale and below it for some layers (not where relu6 saturates more than
    0.1 % of a tensor at 6), and QUANT_PER_CHANNEL_ACT is ignored in
    percentile mode, as in JAX."""
    v, vf, calib = setup
    jcfg, pcfg = _cfgs(QUANT_CALIB_PCT=99.9, QUANT_PER_CHANNEL_ACT=True)
    want = jquant.QuantizedDetector.from_variables(vf, jcfg, calib).graph
    got = _port_graph(v, pcfg, calib)
    absmax = _port_graph(v, PortQ(), calib)
    below = 0
    for g, w, a in zip(_layers(got), _layers(want), _layers(absmax)):
        assert isinstance(g.a_scale, float) and not g.act_folded, g.name
        np.testing.assert_allclose(g.a_scale, w.a_scale, rtol=1e-4, err_msg=g.name)
        assert g.a_scale <= a.a_scale * (1 + 1e-6)
        below += g.a_scale < a.a_scale
    assert below > 5


def test_percentile_interpolates_like_numpy():
    """_percentile sorts and interpolates linearly: numpy's default, also
    past torch.quantile's 16 M element limit (not exercised at this size)."""
    x = torch.tensor(np.random.RandomState(0).rand(7, 11, 13).astype(np.float32))
    for pct in (50.0, 99.9, 12.5, 100.0):
        np.testing.assert_allclose(quant._percentile(x, pct).item(),
                                   np.percentile(x.numpy().astype(np.float64), pct), rtol=1e-6)


def test_mask_f32_layers_graph_matches_jax(setup):
    """(c) QUANT_MASK_F32_LAYERS: the named mask layers stay unquantized
    (bf16) in both graphs, every other field equal; the chained int8 path
    runs, and the fused mask kernel's packer refuses the graph."""
    v, vf, calib = setup
    jcfg, pcfg = _cfgs(QUANT_MASK_F32_LAYERS=("mask_conv4", "mask_deconv"))
    want = jquant.QuantizedDetector.from_variables(vf, jcfg, calib).graph
    det = quant.QuantizedDetector.from_variables(v, pcfg, calib, device="cpu")
    for g, w in zip(_layers(det.graph), _layers(want)):
        assert (g.quantize, g.w_q is None) == (w.quantize, w.w_q is None), g.name
        np.testing.assert_array_equal(g.kernel, np.asarray(w.kernel), err_msg=g.name)
        np.testing.assert_allclose(g.a_scale, w.a_scale, rtol=1e-5, err_msg=g.name)
        if w.w_q is not None:
            np.testing.assert_array_equal(g.w_q, np.asarray(w.w_q), err_msg=g.name)
    kept = {l.name for l in det.graph["mask"] if not l.quantize}
    assert kept == {"mask_conv4", "mask_deconv", "mask_out"}
    out = det.detect_outputs(torch.tensor(calib[:2]), fused_mask=False)
    assert torch.isfinite(out["scores"]).all()
    with pytest.raises(ValueError, match="QUANT_MASK_F32_LAYERS"):
        det.detect_outputs(torch.tensor(calib[:2]), fused_mask=True)


@pytest.fixture(scope="module")
def bias_corrected(setup, jax_per_tensor):
    """JAX's per-tensor graph carried across, then bias-corrected by each
    package on the same calibration images."""
    _, _, calib = setup
    graph = weights.from_jax_graph(jax_per_tensor.graph)
    quant.bias_correct(graph, PortQ(), torch.tensor(calib))
    jgraph = jquant.bias_correct(jax_per_tensor.graph, JaxQ(), calib)
    return graph, jgraph


def test_bias_correct_matches_jax(setup, bias_corrected):
    """(d) bias_corr of every int8 layer against JAX's on the same graph.
    The correction is a mean over N·H·W positions of f32 − int8
    pre-activations; an input value within 1e-6 of a rounding boundary may
    quantize one step apart in the two packages, which moves one term of
    the mean by about w_scale·a_scale·|w_q|. At TinyConfig (4 images, maps
    down to 2×2, so means over as few as 16 positions) one such flip moved
    one channel of 512 by 3.6 % of its layer's largest correction; so every
    entry is held to 5 % of the layer's largest correction plus 1e-6, and
    97 % of all entries to a tenth of that (98.5 % here); the f32 layers
    get none."""
    graph, jgraph = bias_corrected
    n = close = total = 0
    for g, w in zip(_layers(graph), _layers(jgraph)):
        if not (w.quantize and w.w_q is not None):
            assert g.bias_corr is None and w.bias_corr is None, g.name
            continue
        want = np.asarray(w.bias_corr)
        assert g.bias_corr.dtype == np.float32 and g.bias_corr.shape == want.shape, g.name
        tol = 0.05 * np.abs(want).max() + 1e-6
        np.testing.assert_allclose(g.bias_corr, want, rtol=0, atol=tol, err_msg=g.name)
        close += int((np.abs(g.bias_corr - want) <= 0.1 * tol).sum())
        total += want.size
        n += 1
    assert n == len([l for l in _layers(graph) if l.quantize])
    assert close / total >= 0.97, close / total


def test_bias_correct_zeroes_the_mean_error(setup, bias_corrected):
    """(d) The direct contract (tests/test_quant.py): on the calibration
    batch the corrected layer's mean pre-activation error is ~0; the f32
    path ignores the correction."""
    _, _, calib = setup
    graph, _ = bias_corrected
    lay = graph["trunk"][0]
    x = torch.tensor(calib)
    y_f = quant._conv_f32(x, torch.tensor(lay.kernel), lay.strides, lay.groups)
    y_q = quant._conv_int8(quant.quantize(x, lay.a_scale), torch.tensor(lay.w_q), lay.strides,
                           lay.groups).float() * (torch.tensor(lay.w_scale)
                                                  * float(np.float32(lay.a_scale)))
    resid = (y_f - (y_q + torch.tensor(lay.bias_corr))).mean(dim=(0, 1, 2))
    assert resid.abs().max().item() < 1e-5
    kept, lay.bias_corr = lay.bias_corr, None
    without = quant.run_layer_f32(lay, x)
    lay.bias_corr = kept
    assert torch.equal(quant.run_layer_f32(lay, x), without)


def test_bias_corrected_chained_detect_matches_jax(setup, bias_corrected, jax_per_tensor):
    """(d) JAX's bias-corrected graph carried across (bias_corr included):
    the port's chained int8 detect_outputs against JAX's. The int8 tensors
    between layers may differ by a step where a value sits on a rounding
    boundary, and this random tree's YOLO head amplifies a step: valid is
    identical, scores agree to 2e-2, at least 70 % of the box coordinates
    (pixels of a 64² image) to 1e-3 and all to 3 % of the image side (1.02
    px was the largest here; tests/test_quant.py holds int8 to f32 at 5 %),
    and the masks on 99 % of pixels."""
    _, _, calib = setup
    _, jgraph = bias_corrected
    det = quant.QuantizedDetector(weights.from_jax_graph(jgraph), PortQ())
    assert all(l.bias_corr is not None for l in _layers(det.graph) if l.w_q is not None)
    got = {k: t.numpy() for k, t in det.detect_outputs(
        torch.tensor(calib), fused_mask=False, fused_ds=False).items()}
    jchained = jquant.QuantizedDetector(jgraph, _cfgs(QUANT_FUSED_DS=False)[0])
    want = {k: np.asarray(t) for k, t in jchained.detect_outputs(jnp.asarray(calib)).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=2e-2)
    gb, wb = got["boxes"][want["valid"]], want["boxes"][want["valid"]]
    np.testing.assert_allclose(gb, wb, atol=0.03 * JaxQ.IMAGE_SHAPE[0])
    assert (np.abs(gb - wb) < 1e-3).mean() >= 0.7
    assert (got["masks"] == want["masks"]).mean() > 0.99


def _jax_params(layers):
    return {l.name: {"kernel": jnp.asarray(l.kernel, jnp.float32),
                     "bias": jnp.asarray(l.bias, jnp.float32)}
            for l in layers if l.quantize and l.w_q is not None}


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("part", ["mask", "trunk"])
def test_fake_quant_forward_and_gradients_match_jax(setup, jax_per_tensor, part, per_channel):
    """(e) One _run_layers_fq forward and its gradients with respect to
    every tuned kernel and bias against jax.grad of the JAX package's, on
    the same graph (carried across) and input, for a normalized-MSE loss
    against a random target. The straight-through estimator makes the
    gradient a smooth function of the fake-quantized values, so the two
    agree like two f32 sums: the loss to rtol 1e-5, every gradient leaf to
    rtol 1e-4 of its own largest entry (a single entry near zero has no
    relative scale). The reference is JAX's op-by-op result: under jax.jit
    XLA rewrites the per-channel graph's divisions by constant vectors, and
    its own gradients then sit 1e-3 to 1e-2 of a leaf's largest entry away
    from its op-by-op ones (the port agrees with those to ~1e-6)."""
    v, vf, calib = setup
    if per_channel:
        jcfg, _ = _cfgs(QUANT_PER_CHANNEL_ACT=True)
        jgraph = jquant.QuantizedDetector.from_variables(vf, jcfg, calib).graph
    else:
        jgraph = jax_per_tensor.graph
    graph = weights.from_jax_graph(jgraph)
    rng = np.random.RandomState(7)
    if part == "trunk":
        x = calib[:2]
    else:
        cin = jgraph["mask"][0].kernel.shape[2]
        x = rng.rand(6, JaxQ.MASK_POOL_SIZE, JaxQ.MASK_POOL_SIZE, cin).astype(np.float32)
        x *= 127 * np.max(np.asarray(jgraph["mask"][0].a_scale))
    jlayers, layers = jgraph[part], graph[part]

    jparams = _jax_params(jlayers)
    target = np.asarray(jquant._run_layers_fq(jlayers, jnp.asarray(x), jparams))
    target = (target + rng.normal(0, 0.3 * target.std() + 1e-3, target.shape)).astype(np.float32)

    def jloss(p):
        y = jquant._run_layers_fq(jlayers, jnp.asarray(x), p)
        return jnp.mean((y - target) ** 2) / (jnp.mean(target ** 2) + 1e-8)

    jl, jg = jax.value_and_grad(jloss)(jparams)

    params = {name: {k: torch.tensor(np.asarray(a), requires_grad=True) for k, a in p.items()}
              for name, p in jparams.items()}
    loss = quant._nmse(quant._run_layers_fq(layers, torch.tensor(x), params),
                       torch.tensor(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert params
    for name, p in params.items():
        for key, t in p.items():
            want = np.asarray(jg[name][key])
            assert np.abs(want).max() > 0, (name, key)
            np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(), err_msg=f"{name}/{key}")


def test_finetune_reduces_the_loss_and_keeps_the_f32_layers(setup):
    """(e) A 60-step finetune (tests/test_quant.py's contract): loss_final <
    loss_initial, the stored f32 kernels and the f32 path untouched, the
    tuned result only in w_q / w_scale / bias_corr, the int8 trunk still
    within int8 noise of f32, detect runs."""
    v, _, calib = setup
    images = torch.tensor(calib[:2])
    det = quant.QuantizedDetector.from_variables(v, PortQ(), calib[:2], device="cpu")
    with torch.inference_mode():
        g_f = det.trunk(images, quant=False)[0]
    kernels = [l.kernel.copy() for l in _layers(det.graph)]
    w_q = [None if l.w_q is None else l.w_q.copy() for l in _layers(det.graph)]
    r = det.finetune(calib[:2], steps=60)
    assert r["loss_final"] < r["loss_initial"], r
    for l, k in zip(_layers(det.graph), kernels):
        np.testing.assert_array_equal(l.kernel, k, err_msg=l.name)
    tuned = [l for l in _layers(det.graph) if l.w_q is not None]
    assert all(l.bias_corr is not None and l.bias_corr.dtype == np.float32 for l in tuned)
    assert all(l.bias_corr is None for l in _layers(det.graph) if l.w_q is None)
    assert any(not np.array_equal(l.w_q, q) for l, q in zip(_layers(det.graph), w_q)
               if q is not None)
    with torch.inference_mode():
        assert torch.equal(det.trunk(images, quant=False)[0], g_f)
        g_q = det.trunk(images, quant=True)[0]
    scale = g_f.abs().max().item()
    assert (g_q - g_f).abs().max().item() < 0.1 * scale + 0.05
    out = det.detect_outputs(images)
    assert out["boxes"].shape == (2, PortQ.DETECTION_MAX_INSTANCES, 4)


def test_finetune_tracks_jax(setup, jax_per_tensor):
    """(e) The same graph tuned by both packages. The first loss (no update
    yet) agrees to rtol 1e-4 (1.2e-6 here), and one step's gradients are
    held by the test above. Adam's first steps move every weight by lr
    whatever its gradient's size, so a weight whose gradient is rounding
    noise moves by ±lr with that noise's sign, and two f32 trajectories
    drift apart within two updates (6 % after 2 steps, 16 % after 6 here):
    the 6-step run is held loosely, both losses below 0.9× the start and
    within 30 % of each other."""
    _, vf, calib = setup
    jdet = jquant.QuantizedDetector.from_variables(vf, JaxQ(), calib[:2])
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), PortQ(), device="cpu")
    want = jdet.finetune(calib[:2], steps=6)
    got = det.finetune(calib[:2], steps=6)
    np.testing.assert_allclose(got["loss_initial"], want["loss_initial"], rtol=1e-4)
    np.testing.assert_allclose(got["loss_final"], want["loss_final"], rtol=0.3)
    assert got["loss_final"] < 0.9 * got["loss_initial"]
    assert want["loss_final"] < 0.9 * want["loss_initial"]


def test_finetune_keeps_the_best_point_and_honours_the_mask_weight(setup):
    """A learning rate far too large: the loss rises after the first steps,
    and the best observed point (at worst the start) is what is kept.
    QUANT_QAT_MASK_WEIGHT scales the mask term of the loss."""
    v, _, calib = setup
    det = quant.QuantizedDetector.from_variables(v, PortQ(), calib[:2], device="cpu")
    r = det.finetune(calib[:2], steps=3, lr=0.5)
    assert r["loss_final"] <= r["loss_initial"]
    heavy = type("MW", (PortQ,), {"QUANT_QAT_MASK_WEIGHT": 4.0})()
    a = quant.QuantizedDetector.from_variables(v, PortQ(), calib[:2], device="cpu")
    b = quant.QuantizedDetector.from_variables(v, heavy, calib[:2], device="cpu")
    la = a.finetune(calib[:2], steps=1)["loss_initial"]
    lb = b.finetune(calib[:2], steps=1)["loss_initial"]
    assert lb > la
    none = quant.QuantizedDetector.from_variables(v, PortQ(), calib[:2], device="cpu")
    assert none.finetune(calib[:2], steps=0)["loss_final"] <= la * (1 + 1e-6)


def test_model_quantize_finetunes_through_the_facade(setup):
    """(f) MaskYOLO.quantize(calib, finetune_steps=5, finetune_lr=) runs the
    finetune and serves the tuned int8 detector."""
    v, _, calib = setup
    model = MaskYOLO("inference", PortQ(), device="cpu")
    model.load_jax_variables(v)
    plain = model.quantize(calib[:2])
    assert all(l.bias_corr is None for l in _layers(plain.graph))
    qdet = model.quantize((calib[:2] * 255).astype(np.uint8), finetune_steps=5, finetune_lr=1e-5)
    assert qdet is model._qdet
    assert all(l.bias_corr is not None for l in _layers(qdet.graph) if l.w_q is not None)
    res = model.detect((calib[0] * 255).astype(np.uint8), cs_threshold=0.0, display=False)[0]
    assert res["full_masks"].shape[:2] == tuple(PortQ.IMAGE_SHAPE[:2])


def test_per_channel_and_bias_correct_compose(setup):
    """(g) Both knobs through from_variables: vector scales folded, every
    int8 layer corrected, the int8 trunk within int8 noise of f32 (the bound
    of tests/test_quant.py), fused and chained paths agreeing: K1 and K3
    both take the vector scales (test_torch_ds_vector.py counts K1's
    calls)."""
    v, _, calib = setup
    _, pcfg = _cfgs(QUANT_PER_CHANNEL_ACT=True, QUANT_BIAS_CORRECT=True)
    det = quant.QuantizedDetector.from_variables(v, pcfg, calib, device="cpu")
    for l in _layers(det.graph):
        assert isinstance(l.a_scale, np.ndarray)
        assert (l.bias_corr is not None) == (l.w_q is not None), l.name
    images = torch.tensor(calib)
    with torch.inference_mode():
        g_f = det.trunk(images, quant=False)[0]
        g_q = det.trunk(images, quant=True, fused_ds=False)[0]
        g_k = det.trunk(images, quant=True, fused_ds=True)[0]
    scale = g_f.abs().max().item()
    assert (g_q - g_f).abs().max().item() < 0.1 * scale + 0.05
    assert torch.equal(g_q, g_k)
    fused = det.detect_outputs(images, fused_mask=True)
    chained = det.detect_outputs(images, fused_mask=False)
    for key in ("boxes", "classes", "scores", "valid"):
        assert torch.equal(fused[key], chained[key]), key
    assert (fused["masks"] == chained["masks"]).float().mean().item() > 0.995
