"""Port ops vs the JAX ops on the same numpy inputs: decode, IoU, index-order
NMS, interpolation matrices, mask paste, and the crop (plain twin of the
CUDA kernel) against both the XLA crop and the Pallas kernel in interpret
mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_yolo_tpu.ops import boxes as jboxes
from mask_yolo_tpu.ops import nms as jnms
from mask_yolo_tpu.ops import roi_align as jroi
from mask_yolo_tpu.ops.pallas_crop import crop_rois as pallas_crop_rois
from mask_yolo_tpu_torch.ops import boxes, nms, roi_align
from mask_yolo_tpu_torch.ops.roi_crop import crop_rois

torch.set_num_threads(2)

T = torch.tensor


def _boxes(rng, b, k, off_map=False):
    x1 = rng.rand(b, k).astype(np.float32) * 0.6
    y1 = rng.rand(b, k).astype(np.float32) * 0.6
    x2 = x1 + 0.05 + rng.rand(b, k).astype(np.float32) * (0.95 - x1 - 0.05)
    y2 = y1 + 0.05 + rng.rand(b, k).astype(np.float32) * (0.95 - y1 - 0.05)
    out = np.stack([x1, y1, x2, y2], axis=-1)
    if off_map:  # boxes that run off every edge of the map
        out[:, 0] = [-0.5, -0.3, 0.5, 0.6]
        out[:, 1] = [0.6, 0.55, 1.4, 1.2]
    return out


def test_decode_detections(rng):
    """Elementwise f32 exp/sigmoid: XLA and torch CPU may differ by an ULP."""
    grid = rng.randn(2, 3, 4, 2, 8).astype(np.float32) * 2
    anchors = np.asarray([[0.6, 0.7], [1.2, 1.1]], np.float32)
    want = np.asarray(jboxes.decode_detections(jnp.asarray(grid), anchors, 3, 4))
    got = boxes.decode_detections(T(grid), anchors, 3, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])  # class ids


def test_box_iou_and_norm_boxes(rng):
    """IoU: pure f32 arithmetic in the same order, exact (NaN for 0/0
    included). norm_boxes: XLA may divide by the constant scale as a
    multiply by its reciprocal, one ULP (1.2e-7 relative) apart."""
    a = _boxes(rng, 1, 6)[0]
    b = _boxes(rng, 1, 5)[0]
    b[0] = [0.2, 0.2, 0.2, 0.2]   # zero area against itself → 0/0
    for x, y in ((a, b), (b, b)):
        np.testing.assert_array_equal(
            boxes.box_iou_matrix(T(x), T(y)).numpy(),
            np.asarray(jboxes.box_iou_matrix(jnp.asarray(x), jnp.asarray(y))))
    px = a * 63.0
    np.testing.assert_allclose(boxes.norm_boxes(T(px), (64, 48)).numpy(),
                               np.asarray(jboxes.norm_boxes(jnp.asarray(px), (64, 48))),
                               rtol=2.4e-7, atol=0)


def test_index_order_nms_with_ties_and_invalid_slots(rng):
    """Boolean result: must be identical, batched over images."""
    n = 12
    bx = _boxes(rng, 3, n)
    bx[:, 5] = bx[:, 4]                  # exact duplicate → IoU 1 tie
    bx[:, 7] = bx[:, 6] + 0.01           # near duplicate
    cls = rng.randint(0, 3, (3, n)).astype(np.int32)
    cls[:, 5] = cls[:, 4]
    cls[:, 7] = cls[:, 6]
    valid = rng.rand(3, n) > 0.25
    valid[:, 4] = False                  # an invalid slot neither suppresses
    got = nms.index_order_class_nms_mask(T(bx), T(cls), T(valid), 0.3).numpy()
    for i in range(3):
        want = np.asarray(jnms.index_order_class_nms_mask(
            jnp.asarray(bx[i]), jnp.asarray(cls[i]), jnp.asarray(valid[i]), 0.3))
        np.testing.assert_array_equal(got[i], want)
    assert not got[:, 4].any()


@pytest.mark.parametrize("out_size", [1, 5, 14])
def test_interp_matrix(rng, out_size):
    """The sample coordinates feed the CUDA kernel's bit-exact contract:
    identical f32 results."""
    lo = rng.rand(7).astype(np.float32) * 1.2 - 0.3
    hi = lo + rng.rand(7).astype(np.float32)
    want = np.asarray(jroi.interp_matrix(jnp.asarray(lo), jnp.asarray(hi), 9, out_size))
    got = roi_align.interp_matrix(T(lo), T(hi), 9, out_size).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paste_masks(rng, dtype):
    """f32: two small f32 contractions, 1e-5. bf16: weights, masks and the
    intermediate round to bf16 (8 mantissa bits) in both; summation order
    differs, so values in [0, 1] agree to 2^-6."""
    masks = rng.rand(2, 5, 8, 8).astype(np.float32)
    bx = _boxes(rng, 2, 5)
    got = roi_align.paste_masks(T(masks), T(bx), (20, 24),
                                dtype=getattr(torch, dtype)).float().numpy()
    for i in range(2):
        want = np.asarray(jroi.paste_masks(jnp.asarray(masks[i]), jnp.asarray(bx[i]),
                                           (20, 24), dtype=getattr(jnp, dtype)),
                          dtype=np.float32)
        tol = 1e-5 if dtype == "float32" else 2 ** -6
        np.testing.assert_allclose(got[i], want, atol=tol, rtol=0)


@pytest.mark.parametrize("pool", [1, 4, 6])
def test_plain_crop_matches_xla_crop_f32(rng, pool):
    """f32 twin vs XLA crop at HIGHEST precision: two f32 contractions over
    H or W terms; 1e-5 of the map's scale. Off-map boxes included."""
    fmap = rng.randn(2, 10, 12, 16).astype(np.float32)
    bx = _boxes(rng, 2, 7, off_map=True)
    before = crop_rois.launches
    got = crop_rois(T(fmap), T(bx), pool).numpy()
    assert crop_rois.launches == before          # CPU: plain path, no launch
    want = np.asarray(jroi.crop_and_resize(jnp.asarray(fmap), jnp.asarray(bx), (pool, pool)))
    assert got.shape == want.shape == (2, 7, pool, pool, 16)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(fmap).max(), rtol=0)


def test_plain_crop_bf16_matches_pallas_kernel(rng):
    """bf16 twin vs the Pallas kernel in interpret mode, with the bounds of
    tests/test_pallas_crop.py: both round intermediates to bf16, in
    different orders."""
    b, h, w, c, k, pool = 2, 20, 20, 256, 7, 6
    fmap = rng.randn(b, h, w, c).astype(np.float32)
    bx = _boxes(rng, b, k, off_map=True)
    want = np.asarray(pallas_crop_rois(jnp.asarray(fmap), jnp.asarray(bx), pool=pool,
                                       k_block=4, interpret=True)).astype(np.float32)
    got = crop_rois(T(fmap).bfloat16(), T(bx), pool)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-2)
    assert np.mean(np.abs(got - want)) < 2e-2 * scale


def test_crop_wrapper_rejects_what_the_kernel_does_not_take():
    fmap = torch.zeros(1, 4, 4, 8)
    bx = torch.zeros(1, 2, 4)
    with pytest.raises(TypeError):
        crop_rois(fmap.half(), bx, 2)
    with pytest.raises(TypeError):
        crop_rois(fmap, bx.double(), 2)
    with pytest.raises(ValueError):
        crop_rois(fmap, torch.zeros(1, 2, 3), 2)
    with pytest.raises(ValueError):
        crop_rois(fmap, torch.zeros(2, 2, 4), 2)
    # a device that is neither cpu nor cuda never reaches the plain twin
    with pytest.raises(ValueError, match="cpu or cuda"):
        crop_rois(fmap.to("meta"), bx.to("meta"), 2)


def _zero_area_and_mirrored(bx):
    """A zero-area box and an x/y-mirrored one (x2 < x1, y2 < y1) in the
    last two slots of image 0."""
    bx = bx.copy()
    bx[0, -2] = [0.3, 0.4, 0.3, 0.4]
    bx[0, -1] = [0.8, 0.7, 0.2, 0.1]
    return bx


@pytest.mark.parametrize("pool", [1, 4, 6])
def test_crop_backward_plain_matches_jax_vjp(rng, pool):
    """The K2 backward's plain version against jax.vjp of the JAX crop, and
    against torch autograd of the port's forward twin: 1e-5 of the
    gradient's scale. Off-map, zero-area and mirrored boxes included."""
    import jax

    fmap = rng.randn(2, 10, 12, 16).astype(np.float32)
    bx = _zero_area_and_mirrored(_boxes(rng, 2, 7, off_map=True))
    g = rng.randn(2, 7, pool, pool, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jroi.crop_and_resize(f, jnp.asarray(bx), (pool, pool)),
                     jnp.asarray(fmap))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = roi_align.crop_and_resize_backward(T(g), T(bx), (10, 12)).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    f = T(fmap).requires_grad_()
    roi_align.crop_and_resize(f, T(bx), (pool, pool)).backward(T(g))
    np.testing.assert_allclose(got, f.grad.numpy(), atol=tol, rtol=0)


def test_crop_autograd_wiring_on_cpu(rng):
    """crop_rois on an f32 fmap that requires grad goes through the
    autograd.Function: the plain backward on CPU tensors (no kernel
    launch), a gradient for the fmap, none for the boxes; a bf16 fmap that
    requires grad raises (bf16 training is not ported)."""
    from mask_yolo_tpu_torch.ops.roi_crop import crop_rois_backward

    fmap = T(rng.randn(2, 10, 12, 16).astype(np.float32)).requires_grad_()
    bx = T(_boxes(rng, 2, 5, off_map=True)).requires_grad_()
    g = T(rng.randn(2, 5, 4, 4, 16).astype(np.float32))
    launches = crop_rois.launches, crop_rois_backward.launches
    out = crop_rois(fmap, bx, 4)
    assert out.grad_fn is not None
    out.backward(g)
    assert (crop_rois.launches, crop_rois_backward.launches) == launches
    assert bx.grad is None
    want = roi_align.crop_and_resize_backward(g, bx.detach(), (10, 12))
    assert torch.equal(fmap.grad, want)
    # a bf16 fmap trains too: the plain backward on the upcast gradient,
    # rounded once
    fmap16 = fmap.detach().bfloat16().requires_grad_()
    crop_rois(fmap16, bx.detach(), 4).backward(g.bfloat16())
    assert fmap16.grad.dtype == torch.bfloat16
    assert torch.equal(fmap16.grad, roi_align.crop_and_resize_backward(
        g.bfloat16().float(), bx.detach(), (10, 12)).bfloat16())
    with pytest.raises(ValueError):
        crop_rois_backward(g, bx.detach()[:, :3].contiguous(), (10, 12))


def test_per_roi_crop_matches_jax(rng):
    """The f32 single-channel crop of target assignment: 1e-6 of the
    masks' scale (values in [0, 1])."""
    masks = (rng.rand(6, 16, 20) > 0.5).astype(np.float32)
    bx = _boxes(rng, 1, 6, off_map=True)[0]
    want = np.asarray(jroi.crop_and_resize_per_roi(jnp.asarray(masks), jnp.asarray(bx), (8, 8)))
    got = roi_align.crop_and_resize_per_roi(T(masks), T(bx), (8, 8)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
