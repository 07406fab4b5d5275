"""The ROI crop (K2) on the CPU: the plain versions of the backward kernel's
two stages (`roi_crop.backward_index`, `roi_crop.backward_through_index`)
against the JAX crop's gradient at TinyConfig sizes, and the F.grid_sample
yardstick that chip_smoke.py times beside the kernels (`library_ms`) against
the plain crop and its gradient. Boxes run off the map, and include a
zero-area and a mirrored one (x2 < x1, y2 < y1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conftest import TinyConfig
from mask_yolo_tpu.ops import roi_align as jroi
from mask_yolo_tpu_torch.ops import roi_align, roi_crop

torch.set_num_threads(2)

T = torch.tensor


def _boxes(rng, b, k):
    """Boxes in slots 0-3 run off every edge; in image 0 slot 4 is
    zero-area, slot 5 mirrored; the rest lie on the map. No sample lands
    exactly on the map's edge (c = 0 or n), where the inclusion of a sample
    turns on the last bit of its coordinate and XLA's fusions of the JAX
    crop's gradient may round it otherwise than its forward does."""
    x1 = rng.rand(b, k) * 0.6
    y1 = rng.rand(b, k) * 0.6
    bx = np.stack([x1, y1, x1 + 0.05 + rng.rand(b, k) * 0.35,
                   y1 + 0.05 + rng.rand(b, k) * 0.35], axis=-1)
    bx[:, :4] = [[-0.45, -0.35, 0.55, 0.65], [0.62, 0.57, 1.37, 1.23],
                 [-0.23, 0.71, 0.33, 1.13], [0.91, -0.41, 1.29, 0.19]]
    bx[0, 4] = [0.3, 0.4, 0.3, 0.4]
    bx[0, 5] = [0.8, 0.7, 0.2, 0.1]
    return bx.astype(np.float32)


def _tiny_shape():
    """(B, H, W, C, K, P) of TinyConfig's crop: its neck map (stride 8), its
    mask ROIs and pool."""
    cfg = TinyConfig()
    h, w = cfg.IMAGE_SHAPE[0] // 8, cfg.IMAGE_SHAPE[1] // 8
    return (cfg.BATCH_SIZE, h, w, cfg.TOP_FEATURE_MAP_DEPTH, cfg.TRAIN_ROIS_PER_IMAGE,
            cfg.MASK_POOL_SIZE)


@pytest.mark.parametrize("hw", [None, (9, 13), (6, 70)], ids=["tiny", "odd-rows", "wide"])
@pytest.mark.parametrize("pool", [1, None, 14], ids=["P1", "tiny", "P14"])
def test_backward_through_index_matches_jax_vjp(rng, hw, pool):
    """The backward summed only through the per-band lists and per-column
    ranges equals jax.vjp of the JAX crop and the plain backward: f32
    contractions in another order, 1e-5 of the gradient's scale. None:
    TinyConfig's neck map and MASK_POOL_SIZE; odd-rows: a last band of one
    row; wide: more columns than one backward block takes."""
    b, h, w, c, k, tiny_pool = _tiny_shape()
    h, w = hw or (h, w)
    pool = pool or tiny_pool
    bx = _boxes(rng, b, k)
    g = rng.randn(b, k, pool, pool, c).astype(np.float32)
    fmap = rng.randn(b, h, w, c).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jroi.crop_and_resize(f, jnp.asarray(bx), (pool, pool)),
                     jnp.asarray(fmap))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    index = roi_crop.backward_index(T(bx), (h, w), pool)
    got = roi_crop.backward_through_index(T(g), T(bx), (h, w), index).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    plain = roi_align.crop_and_resize_backward(T(g), T(bx), (h, w)).numpy()
    np.testing.assert_allclose(got, plain, atol=tol, rtol=0)


@pytest.mark.parametrize("pool", [1, 4, 14])
def test_backward_index_lists_exactly_the_touching_rows(rng, pool):
    """Each band's list is ascending and holds exactly the sample rows with
    a non-zero y weight on one of its rows; each column's range holds every
    px with a non-zero x weight on it, and no such px lies outside (the
    sample points are monotone in px, so the range is contiguous)."""
    b, h, w, k = 2, 10, 13, 7
    bx = T(_boxes(rng, b, k))
    lists, first, count = roi_crop.backward_index(bx, (h, w), pool)
    x1, y1, x2, y2 = bx.unbind(-1)
    wy = roi_align.interp_matrix(y1, y2, h, pool).reshape(b, k * pool, h)
    wx = roi_align.interp_matrix(x1, x2, w, pool)                        # [B, K, P, W]
    n = roi_crop.BWD_BAND_ROWS
    for i in range(b):
        assert len(lists[i]) == -(-h // n)
        for j, rows in enumerate(lists[i]):
            want = torch.nonzero((wy[i, :, n * j:n * (j + 1)] != 0).any(-1)).flatten()
            assert torch.equal(rows, want)
    px = torch.arange(pool)[:, None]
    inside = (px >= first[:, :, None]) & (px < (first + count)[:, :, None])   # [B, K, P, W]
    assert torch.equal(inside, wx != 0)


@pytest.mark.parametrize("pool", [1, 14])
@pytest.mark.parametrize("hw", [(12, 12), (10, 16)], ids=["square", "non-square"])
def test_grid_sample_yardstick_computes_the_crop(rng, pool, hw):
    """One F.grid_sample call (border padding, corners aligned), times the
    on-map mask, is K2's forward: 1e-5 of the output's scale in f32."""
    h, w = hw
    fmap = T(rng.randn(2, h, w, 16).astype(np.float32))
    bx = T(_boxes(rng, 2, 9))
    x, grid, mask = chip_smoke.grid_sample_operands(fmap, bx, pool)
    got = chip_smoke.from_grid_layout(chip_smoke.grid_sample_crop(x, grid), 9, pool) * mask
    want = roi_align.crop_and_resize(fmap, bx, (pool, pool))
    assert got.shape == want.shape == (2, 9, pool, pool, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * want.abs().max().item(),
                               rtol=0)


@pytest.mark.parametrize("pool", [1, 14])
@pytest.mark.parametrize("hw", [(12, 12), (10, 16)], ids=["square", "non-square"])
def test_grid_sample_yardstick_gradient_is_the_crop_backward(rng, pool, hw):
    """autograd through the yardstick, with the mask applied to the
    incoming gradient, is K2's backward: 1e-5 of the gradient's scale."""
    h, w = hw
    bx = T(_boxes(rng, 2, 9))
    g = T(rng.randn(2, 9, pool, pool, 16).astype(np.float32))
    got, again = chip_smoke.grid_sample_backward(torch.zeros(2, h, w, 16), bx, g)
    want = roi_align.crop_and_resize_backward(g, bx, (h, w))
    tol = 1e-5 * want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(again().numpy(), want.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("hw, c, pool", [(None, None, None), ((9, 13), 6, 4), ((12, 12), 16, 65),
                                         ((6, 70), 10, 14)],
                         ids=["tiny", "C6", "P65", "wide-C10"])
def test_bf16_backward_plain_version_matches_jax_bf16_gradient(rng, hw, c, pool):
    """`crop_rois_backward` on a bf16 gradient (the plain version on the CPU:
    `crop_and_resize_backward` on the upcast gradient, rounded once) against
    jax.vjp of the JAX crop in bf16, at TinyConfig's shape and at widths the
    CUDA gather does not take (C % 4 != 0, P > 64). The JAX gradient rounds
    its bf16 interpolation weights and its intermediate, the port sums in
    f32 and rounds once: within 3e-2 of the gradient's scale (CROP_TOL's
    bf16 limit; a bf16 ULP is 2^-8 of a value and a few add up), and within
    one bf16 ULP of the largest value of the f32 backward rounded to bf16."""
    b, h, w, tiny_c, k, tiny_pool = _tiny_shape()
    h, w = hw or (h, w)
    c, pool = c or tiny_c, pool or tiny_pool
    bx = _boxes(rng, b, k)
    g = T(rng.randn(b, k, pool, pool, c).astype(np.float32)).bfloat16()
    fmap = jnp.asarray(rng.randn(b, h, w, c).astype(np.float32), jnp.bfloat16)
    _, vjp = jax.vjp(lambda f: jroi.crop_and_resize(f, jnp.asarray(bx), (pool, pool),
                                                    dtype=jnp.bfloat16), fmap)
    want = np.asarray(vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))[0].astype(jnp.float32))
    got = roi_crop.crop_rois_backward(g, T(bx), (h, w))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, c)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2 * scale, rtol=0)
    f32 = roi_align.crop_and_resize_backward(g.float(), T(bx), (h, w))
    assert torch.equal(got, f32.bfloat16())


@pytest.mark.parametrize("c, pool", [(6, 4), (16, 65), (3, 1)], ids=["C6", "P65", "C3-P1"])
def test_f32_backward_takes_every_width(rng, c, pool):
    """C not a multiple of 4 and P > 64 through the wrapper (plain version
    here; the card sends them to the kernel's one-thread-per-value path):
    equal to jax.vjp's gradient to 1e-5 of its scale."""
    b, h, w, _, k, _ = _tiny_shape()
    bx = _boxes(rng, b, k)
    g = rng.randn(b, k, pool, pool, c).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jroi.crop_and_resize(f, jnp.asarray(bx), (pool, pool)),
                     jnp.zeros((b, h, w, c), jnp.float32))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = roi_crop.crop_rois_backward(T(g), T(bx), (h, w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
