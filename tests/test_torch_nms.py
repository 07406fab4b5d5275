"""The port's NMS functions (`mask_yolo_tpu_torch/ops/nms.py`) against the
JAX package's on the same seeded inputs: keep-masks and zeroed scores must
be equal, not close, since both make the same comparisons on the same f32
IoUs (the IoU is the same expression in both, checked here to 1 ULP-free
equality on the boxes used)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_yolo_tpu.ops import nms as jnms
from mask_yolo_tpu_torch.ops import nms

torch.set_num_threads(2)


def _boxes(rng, n):
    """Overlapping normalized boxes on a quarter grid, so many IoUs sit on
    both sides of the threshold and some pairs are identical."""
    xy = rng.integers(0, 12, (n, 2)) / 16.0
    wh = rng.integers(2, 8, (n, 2)) / 16.0
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _scores(rng, n, zero_share=0.3, tied=True):
    s = rng.random(n).astype(np.float32)
    if tied:
        s = np.round(s * 8) / 8        # many ties
    s[rng.random(n) < zero_share] = 0.0
    return s


@pytest.mark.parametrize("n", [1, 7, 147, 512, 845], ids=lambda n: f"n{n}")
@pytest.mark.parametrize("threshold", [0.3, 0.7])
def test_greedy_nms_mask_equals_jax(n, threshold):
    """n <= 512 is the JAX package's unrolled branch, 845 its tiled one; the
    port runs one chain for both. Tied and zero scores included."""
    rng = np.random.default_rng(n)
    boxes, scores = _boxes(rng, n), _scores(rng, n)
    want = np.asarray(jnms.greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), threshold))
    got = nms.greedy_nms_mask(torch.tensor(boxes), torch.tensor(scores), threshold).numpy()
    np.testing.assert_array_equal(got, want)
    if n > 7:
        assert 0 < got.sum() < n             # some suppressed, some kept
        assert nms.greedy_keep.steps == int((scores > 0).sum())


def test_greedy_nms_mask_is_batched():
    """Leading dimensions are independent calls."""
    rng = np.random.default_rng(0)
    boxes = np.stack([_boxes(rng, 40) for _ in range(6)]).reshape(2, 3, 40, 4)
    scores = np.stack([_scores(rng, 40) for _ in range(6)]).reshape(2, 3, 40)
    got = nms.greedy_nms_mask(torch.tensor(boxes), torch.tensor(scores), 0.4).numpy()
    for i in range(2):
        for j in range(3):
            want = jnms.greedy_nms_mask(jnp.asarray(boxes[i, j]), jnp.asarray(scores[i, j]), 0.4)
            np.testing.assert_array_equal(got[i, j], np.asarray(want))


def test_zero_scores_never_suppress_and_never_survive():
    boxes = torch.tensor([[0, 0, 1, 1], [0, 0, 1, 1], [0, 0, 1, 1]], dtype=torch.float32)
    keep = nms.greedy_nms_mask(boxes, torch.tensor([0.0, 0.5, 0.0]), 0.5)
    assert keep.tolist() == [False, True, False]
    # all inactive: nothing suppresses, and the chain runs no step
    keep = nms.greedy_nms_mask(boxes, torch.zeros(3), 0.5)
    assert keep.tolist() == [True, True, True] and nms.greedy_keep.steps == 0


@pytest.mark.parametrize("n, c", [(8, 3), (147, 4), (845, 5)], ids=["tiny", "shapes", "coco"])
def test_class_aware_nms_equals_jax(n, c):
    rng = np.random.default_rng(n + c)
    boxes = np.stack([_boxes(rng, n) for _ in range(2)])
    scores = np.stack([np.stack([_scores(rng, n, 0.6) for _ in range(c)], -1) for _ in range(2)])
    got = nms.class_aware_nms(torch.tensor(boxes), torch.tensor(scores), 0.3).numpy()
    for b in range(2):
        want = jnms.class_aware_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.3)
        np.testing.assert_array_equal(got[b], np.asarray(want))
    if n > 8:
        assert 0 < (got > 0).sum() < (scores > 0).sum()


@pytest.mark.parametrize("k", [4, 16, 64, 200])
def test_per_class_topk_nms_equals_jax(k):
    """Equal to the JAX function at every k (also where a class has more
    than k live boxes and boxes are dropped), and equal to class_aware_nms
    while every class has <= k live boxes."""
    rng = np.random.default_rng(k)
    n, c = 147, 4
    boxes = np.stack([_boxes(rng, n) for _ in range(2)])
    scores = np.stack([np.stack([_scores(rng, n, 0.8) for _ in range(c)], -1) for _ in range(2)])
    got = nms.per_class_topk_nms(torch.tensor(boxes), torch.tensor(scores), k, 0.3).numpy()
    for b in range(2):
        want = jnms.per_class_topk_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), k, 0.3)
        np.testing.assert_array_equal(got[b], np.asarray(want))
    if k >= (scores > 0).sum(1).max():
        full = nms.class_aware_nms(torch.tensor(boxes), torch.tensor(scores), 0.3).numpy()
        np.testing.assert_array_equal(got, full)
    else:
        assert k < (scores > 0).sum(1).max()


@pytest.mark.parametrize("low", [-5.0, -300.0], ids=["plain", "rescaled"])
def test_reference_softmax_equals_jax_per_image(low):
    """The shift is by one image's global maximum (the JAX package calls it
    under vmap), and the rescale fires when the shifted minimum is below
    -100. f32 exp may differ by an ULP between XLA and torch: rtol 2e-6."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3, (3, 2, 2, 2, 5)).astype(np.float32)
    x[1, 0, 0, 0, 0] = low
    x[2] += 40.0                               # another image's maximum must not leak
    got = nms.reference_softmax(torch.tensor(x), batch_dims=1).numpy()
    for b in range(3):
        want = np.asarray(jnms.reference_softmax(jnp.asarray(x[b])))
        np.testing.assert_allclose(got[b], want, rtol=2e-6, atol=1e-30)
    whole = nms.reference_softmax(torch.tensor(x[1])).numpy()
    np.testing.assert_allclose(whole, got[1], rtol=0, atol=0)


def test_top_k_detections_and_index_order_nms_equal_jax():
    rng = np.random.default_rng(5)
    n = 30
    boxes, scores = _boxes(rng, n), _scores(rng, n)
    ids = rng.integers(0, 3, n).astype(np.int32)
    want = jnms.top_k_detections(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ids), 10,
                                 0.35)
    got = nms.top_k_detections(torch.tensor(boxes), torch.tensor(scores), torch.tensor(ids), 10,
                               0.35)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = scores > 0.2
    want = jnms.index_order_class_nms_mask(jnp.asarray(boxes), jnp.asarray(ids),
                                           jnp.asarray(valid), 0.5)
    got = nms.index_order_class_nms_mask(torch.tensor(boxes), torch.tensor(ids),
                                         torch.tensor(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_first_argmax_takes_the_lowest_index_on_ties():
    x = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.7, 0.7], [0.9, 0.2, 0.9]])
    top, idx = nms.first_argmax(x)
    assert idx.tolist() == [0, 1, 0] and top.tolist() == pytest.approx([0.0, 0.7, 0.9])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jnp.argmax(jnp.asarray(x.numpy()), -1)))
