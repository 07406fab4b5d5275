"""K1 (the fused int8 DS block, ops/ds_block.py) on per-channel activation
scales: QUANT_PER_CHANNEL_ACT + QUANT_BIAS_CORRECT graphs at TinyConfig
width (the full MobileNet channel widths at 64²) on the spread tree of
test_torch_quant.py.

The packed operands carry a third row of f32 inverse scales (the pointwise
layer's input scale over C, the output's over O); a per-tensor graph
repeats its scalar. The plain version fed them must equal the chained
layers (quant.run_layer_int8 twice) bit for bit, as the CUDA kernel must
equal the plain version on the card (chip_smoke.py phase 8). The JAX
package's Pallas K1 takes scalar scales only (mask_yolo_tpu/quant.py
`_fusable_ds_pair`), so its per-channel detect runs chained layers; the
port's fused detect is held to it within the bounds of
test_torch_quant_tools.py's chained comparison.

On these CPU tensors the wrapper runs the plain version; the op's calls are
counted by wrapping the plain version the op's CPU kernel looks up."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mask_yolo_tpu import quant as jquant
from mask_yolo_tpu_torch import quant, weights
from mask_yolo_tpu_torch.ops import ds_block
from mask_yolo_tpu_torch.ops.int8 import int_mm, quantize
from test_torch_quant import JaxQ, PortQ, _layers, spread_variables

torch.set_num_threads(2)

PC = {"QUANT_PER_CHANNEL_ACT": True, "QUANT_BIAS_CORRECT": True}
# the stride-1 DS blocks: 4 in the trunk, 6 in the YOLO head
PAIRS = ["block1", "block3", "block5", "block6", "block8", "block9", "block10", "block11",
         "block12", "block14"]


def _port_cfg(**knobs):
    return type("PortPC", (PortQ,), knobs)()


def _calib():
    return np.random.RandomState(21).rand(2, *JaxQ.IMAGE_SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def pc_det():
    """The port's per-channel, bias-corrected detector and its images."""
    v, _, _ = spread_variables()
    calib = _calib()
    return quant.QuantizedDetector.from_variables(v, _port_cfg(**PC), calib, device="cpu"), calib


def _chained_inputs(layers, x):
    """{layer name: (its input, the input's scale)} along the chained int8
    path of quant.run_layers, from an f32 `x`."""
    seen, scale = {}, None
    for i, layer in enumerate(layers):
        seen[layer.name] = (x, scale)
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        nxt_scale = nxt.a_scale if nxt is not None and quant._scale_ok(nxt.a_scale) else None
        x, scale = quant.run_layer_int8(layer, x, scale, nxt_scale)
    return seen, x


@pytest.fixture(scope="module")
def pc_pairs(pc_det):
    """{block: (dw, pw, its int8 input, the input's scale, the output's
    scale or None)} of every stride-1 pair of the per-channel graph, with
    the inputs the chained path hands each pair."""
    det, calib = pc_det
    g = det.graph
    # the neck and the head take C4 at their own vector scales (each layer's
    # SmoothQuant split), so the trunk ends f32 and each quantizes it itself
    assert not np.array_equal(g["neck"][0].a_scale, g["yolo"][0].a_scale)
    out = {}
    with torch.inference_mode():
        trunk_in, c4 = _chained_inputs(g["trunk"], torch.tensor(calib))
        head_in, _ = _chained_inputs(g["yolo"], c4)
    for layers, seen in ((g["trunk"], trunk_in), (g["yolo"], head_in)):
        for i, layer in enumerate(layers):
            if layer.kind != "dw" or layer.strides != (1, 1):
                continue
            nxt2 = layers[i + 2] if i + 2 < len(layers) else None
            s_out = nxt2.a_scale if nxt2 is not None else None
            out[layer.name.split("/")[0]] = (layer, layers[i + 1], *seen[layer.name], s_out)
    return out


def _tensors(arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("block", PAIRS)
def test_vector_plain_equals_the_chained_pair(pc_pairs, block):
    """(a) On every stride-1 pair, the plain K1 fed pack_ds_pair's vector
    operands equals run_layer_int8 twice, bit for bit; the rows are real
    vectors (each layer's scale folded into its weights, so the dequantize
    rows are w_scale alone)."""
    assert sorted(pc_pairs, key=PAIRS.index) == PAIRS
    dw, pw, x, s_in, s_out = pc_pairs[block]
    assert isinstance(s_in, np.ndarray) and isinstance(pw.a_scale, np.ndarray)
    assert dw.act_folded and pw.act_folded and dw.bias_corr is not None
    assert quant._fusable_ds_pair(dw, pw, s_in)
    kdw, dwsb, wpw, pwsb = pack = ds_block.pack_ds_pair(dw, pw, s_in, s_out)
    assert dwsb.shape == (3, dw.w_q.shape[-1]) and pwsb.shape == (3, pw.w_q.shape[-1])
    np.testing.assert_array_equal(dwsb[0], dw.w_scale)
    np.testing.assert_array_equal(dwsb[2], np.float32(1) / pw.a_scale)
    assert len(np.unique(dwsb[2])) > 1
    with torch.inference_mode():
        y1, s1 = quant.run_layer_int8(dw, x, s_in, pw.a_scale)
        want, _ = quant.run_layer_int8(pw, y1, s1, s_out)
        got = ds_block.fused_ds_block_reference(x, *_tensors(pack), out_int8=s_out is not None)
    assert got.dtype == (torch.float32 if block == "block6" else torch.int8)
    assert torch.equal(got, want)
    if got.dtype == torch.int8:
        assert ((want > 0) & (want < 127)).float().mean() > 0.05   # not all clipped


def _two_row_plain(x_q, kdw, dwsb, wpw, pwsb, a_pw, s_out):
    """The plain K1 as it was before the vector rows: two-row operands and
    the requantize at two scalar scales (s_out 0: f32 out)."""
    b, h, w, c = x_q.shape
    xp = F.pad(x_q, (0, 0, 1, 1, 1, 1)).to(torch.int32)
    acc = sum(xp[:, t // 3:t // 3 + h, t % 3:t % 3 + w] * kdw[t].to(torch.int32)
              for t in range(9))
    q = quantize(torch.clamp(acc.float() * dwsb[0] + dwsb[1], 0.0, 6.0), a_pw)
    acc2 = int_mm(q.reshape(-1, c), wpw.t()).reshape(b, h, w, -1)
    y2 = torch.clamp(acc2.float() * pwsb[0] + pwsb[1], 0.0, 6.0)
    return quantize(y2, s_out) if s_out else y2


@pytest.mark.parametrize("out_int8", [True, False], ids=["int8_out", "f32_out"])
@pytest.mark.parametrize("block", ["block1", "block8"])
def test_per_tensor_pair_in_the_vector_layout_is_unchanged(block, out_int8):
    """(b) A per-tensor pair packed in the three-row layout (each scalar
    inverse repeated) gives the output of the two-row, two-scalar
    arithmetic it replaced, bit for bit."""
    v, _, _ = spread_variables()
    det = quant.QuantizedDetector.from_variables(v, PortQ(), _calib(), device="cpu")
    layers = det.graph["trunk"] + det.graph["yolo"]
    i = [l.name for l in layers].index(f"{block}/dw")
    dw, pw, nxt2 = layers[i:i + 3]
    assert isinstance(pw.a_scale, float) and isinstance(nxt2.a_scale, float)
    s_out = nxt2.a_scale if out_int8 else None
    x = torch.tensor(np.random.RandomState(4).randint(
        -127, 128, (2, 9, 7, dw.w_q.shape[-1])).astype(np.int8))
    pack = ds_block.pack_ds_pair(dw, pw, dw.a_scale, s_out)
    assert np.all(pack[1][2] == np.float32(1) / np.float32(pw.a_scale))
    got = ds_block.fused_ds_block(x, *_tensors(pack), out_int8=out_int8)
    two_rows = [torch.as_tensor(a[:2].copy()) if a.shape[0] == 3 else torch.as_tensor(a)
                for a in pack]
    want = _two_row_plain(x, *two_rows, pw.a_scale, s_out or 0.0)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _count_plain_calls(monkeypatch):
    calls = []
    plain = ds_block.fused_ds_block_reference

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ds_block, "fused_ds_block_reference", counted)
    return calls


def test_per_channel_detect_runs_k1_on_every_pair(pc_det, monkeypatch):
    """(c) detect_outputs(fused_ds=True) on the per-channel graph calls the
    K1 op once for each of the 10 stride-1 pairs and equals
    fused_ds=False bit for bit (boxes, classes, scores, valid, masks)."""
    det, calib = pc_det
    images = torch.tensor(calib)
    calls = _count_plain_calls(monkeypatch)
    with torch.inference_mode():
        fused = det.detect_outputs(images, fused_mask=False, fused_ds=True)
        assert len(calls) == len(PAIRS)
        chained = det.detect_outputs(images, fused_mask=False, fused_ds=False)
    assert len(calls) == len(PAIRS)
    assert int(fused["valid"].sum()) > 0
    for key in fused:
        assert torch.equal(fused[key], chained[key]), key


def test_per_channel_fused_detect_matches_jax(monkeypatch):
    """(d) JAX's per-channel, bias-corrected graph carried across: the
    port's detect with K1 on every stride-1 pair against the JAX package's
    per-channel detect (its K1 declines vector scales, so its pairs run as
    chained layers), within test_torch_quant_tools.py's bounds for the
    chained comparison: valid identical, scores to 2e-2, box coordinates
    all to 3 % of the image side and at least 70 % to 1e-3 px, masks on
    99 % of pixels."""
    _, vf, _ = spread_variables()
    calib = _calib()
    jcfg = type("JaxPC", (JaxQ,), PC)()
    jdet = jquant.QuantizedDetector.from_variables(vf, jcfg, calib)
    assert not jquant._fusable_ds_pair(jdet.graph["trunk"][1], jdet.graph["trunk"][2],
                                       jdet.graph["trunk"][1].a_scale)
    det = quant.QuantizedDetector(weights.from_jax_graph(jdet.graph), _port_cfg(**PC))
    assert all(isinstance(l.a_scale, np.ndarray) for l in _layers(det.graph))
    calls = _count_plain_calls(monkeypatch)
    with torch.inference_mode():
        got = {k: t.numpy() for k, t in det.detect_outputs(
            torch.tensor(calib), fused_mask=False, fused_ds=True).items()}
    assert len(calls) == len(PAIRS)
    want = {k: np.asarray(t) for k, t in jdet.detect_outputs(jnp.asarray(calib)).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=2e-2)
    gb, wb = got["boxes"][want["valid"]], want["boxes"][want["valid"]]
    np.testing.assert_allclose(gb, wb, atol=0.03 * JaxQ.IMAGE_SHAPE[0])
    assert (np.abs(gb - wb) < 1e-3).mean() >= 0.7
    assert (got["masks"] == want["masks"]).mean() > 0.99


def test_packed_pair_caches_vector_scales_and_repacks_after_bias_correct():
    """(e) _packed_ds_pair on ndarray scales (no "truth value of an array is
    ambiguous"): a second call returns the cached tensors; a new scale array
    of the same values, or bias_correct replacing the corrections, repacks,
    and the new operands carry the new correction."""
    v, _, _ = spread_variables()
    cfg, calib = _port_cfg(QUANT_PER_CHANNEL_ACT=True), _calib()
    det = quant.QuantizedDetector.from_variables(v, cfg, calib, device="cpu")
    dw, pw, nxt2 = det.graph["trunk"][1:4]
    assert dw.name == "block1/dw" and dw.bias_corr is None
    first = quant._packed_ds_pair(dw, pw, dw.a_scale, nxt2.a_scale, "cpu")
    again = quant._packed_ds_pair(dw, pw, dw.a_scale, nxt2.a_scale, "cpu")
    assert all(a is b for a, b in zip(first, again))
    copy = quant._packed_ds_pair(dw, pw, dw.a_scale.copy(), nxt2.a_scale, "cpu")
    assert not any(a is b for a, b in zip(first, copy))
    assert all(torch.equal(a, b) for a, b in zip(first, copy))
    first = quant._packed_ds_pair(dw, pw, dw.a_scale, nxt2.a_scale, "cpu")
    again = quant._packed_ds_pair(dw, pw, dw.a_scale, nxt2.a_scale, "cpu")
    assert all(a is b for a, b in zip(first, again))
    quant.bias_correct(det.graph, cfg, torch.tensor(calib))
    assert dw.bias_corr is not None and np.abs(dw.bias_corr).max() > 0
    fixed = quant._packed_ds_pair(dw, pw, dw.a_scale, nxt2.a_scale, "cpu")
    np.testing.assert_array_equal(fixed[1][1].numpy(), dw.bias + dw.bias_corr)
    np.testing.assert_array_equal(fixed[3][1].numpy(), pw.bias + pw.bias_corr)
    assert not torch.equal(fixed[1][1], first[1][1])


def _operands(rng, c=32, o=48):
    t = torch.as_tensor
    return [t(rng.randint(-9, 9, (1, 4, 5, c)).astype(np.int8)),
            t(rng.randint(-9, 9, (9, c)).astype(np.int8)),
            t(rng.rand(3, c).astype(np.float32) + 0.1),
            t(rng.randint(-9, 9, (o, c)).astype(np.int8)),
            t(rng.rand(3, o).astype(np.float32) + 0.1)]


@pytest.mark.parametrize("bad", ["dwsb_rows", "pwsb_rows", "dwsb_length", "pwsb_length",
                                 "dwsb_dtype", "pwsb_dtype", "dwsb_device", "pwsb_device"])
def test_wrapper_refuses_bad_scale_rows(bad):
    """(f) The wrapper raises on a scale row table of the wrong row count or
    row length, dtype or device, naming the operand."""
    rng = np.random.RandomState(2)
    args = _operands(rng)
    assert ds_block.fused_ds_block(*args, out_int8=True).shape == (1, 4, 5, 48)
    name, what = bad.split("_")
    k = 2 if name == "dwsb" else 4
    t = args[k]
    args[k] = {"rows": lambda: t[:2].contiguous(),
               "length": lambda: t[:, :-16].contiguous(),
               "dtype": lambda: t.double(),
               "device": lambda: torch.empty(t.shape, dtype=t.dtype, device="meta")}[what]()
    with pytest.raises(ValueError, match=name):
        ds_block.fused_ds_block(*args, out_int8=True)


def test_wrapper_needs_a_bool_output_flag():
    """(f) The output's dtype comes from a bool flag, never from a scale:
    an int or a float in its place raises."""
    args = _operands(np.random.RandomState(3))
    assert ds_block.fused_ds_block(*args, out_int8=False).dtype == torch.float32
    for flag in (1, 0.05):
        with pytest.raises(TypeError, match="out_int8"):
            ds_block.fused_ds_block(*args, out_int8=flag)
