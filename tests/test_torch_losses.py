"""The port's training losses and mask-target assignment vs the JAX package's,
on the same numpy inputs at TinyConfig size, f32.

Limits: loss values within rel 1e-5 of JAX; each input gradient within
1e-4 of the largest |JAX gradient| (+1e-7) — both sides sum in another
order; target class ids identical and target masks equal on >= 99.9 % of
pixels (a crop value within an ULP of 0.5 may round either way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu import losses as jlosses
from mask_yolo_tpu.ops import target_assign as jtarget
from mask_yolo_tpu_torch import losses
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.data.encoder import encode_batch
from mask_yolo_tpu_torch.ops import target_assign

torch.set_num_threads(2)


def port_config(jax_config):
    """The port's Config class with the same upper-case values."""
    values = {k: getattr(jax_config, k) for k in dir(jax_config) if k.isupper()}
    return type("Port" + type(jax_config).__name__, (Config,), values)()


class WarmTiny(TinyConfig):
    WARM_UP_BATCHES = 10


def _yolo_case(rng, cfg, with_gt=True):
    b = cfg.BATCH_SIZE
    h, w = cfg.IMAGE_SHAPE[:2]
    g = cfg.MAX_GT_INSTANCES
    xy = rng.uniform(0, 0.7, (b, g, 2)) * [w, h]
    wh = rng.uniform(0.1, 0.3, (b, g, 2)) * [w, h]
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    ids = rng.randint(1, cfg.NUM_CLASSES, (b, g)).astype(np.int32)
    boxes[:, -1] = 0.0          # padding slots
    ids[:, -1] = 0
    if not with_gt:
        boxes[:] = 0.0
        ids[:] = 0
    y_true, true_boxes = encode_batch(boxes, ids, port_config(cfg))
    y_pred = rng.randn(*y_true.shape).astype(np.float32)
    return y_true, y_pred, true_boxes


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + 1e-7)


@pytest.mark.parametrize("cfg_cls,seen,with_gt", [
    (TinyConfig, 1e9, True),        # warm-up off
    (WarmTiny, 3.0, True),          # warm-up on
    (TinyConfig, 1e9, False),       # no object anywhere
], ids=["warmup_off", "warmup_on", "no_positives"])
def test_yolo_loss_and_gradient_match_jax(rng, cfg_cls, seen, with_gt):
    cfg = cfg_cls()
    y_true, y_pred, true_boxes = _yolo_case(rng, cfg, with_gt)

    def jloss(p):
        return jlosses.yolo_loss(jnp.asarray(y_true), p, jnp.asarray(true_boxes), cfg, seen)

    (want, jmetrics), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(y_pred))
    pred = torch.tensor(y_pred, requires_grad=True)
    got, metrics = losses.yolo_loss(torch.tensor(y_true), pred, torch.tensor(true_boxes),
                                    port_config(cfg), seen)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    _close(pred.grad.numpy(), np.asarray(jgrad), 1e-4)


@pytest.mark.parametrize("positives", [True, False])
def test_mask_loss_and_gradient_match_jax(rng, positives):
    b, r, mh, mw, c = 2, 5, 8, 8, 3
    probs = (1.0 / (1.0 + np.exp(-3 * rng.randn(b, r, mh, mw, c)))).astype(np.float32)
    targets = (rng.rand(b, r, mh, mw) > 0.5).astype(np.float32)
    ids = rng.randint(0, c, (b, r)).astype(np.int32)
    ids[0, 0] = 1
    if not positives:
        ids[:] = 0
    want, jgrad = jax.value_and_grad(lambda p: jlosses.mask_loss(
        jnp.asarray(targets), jnp.asarray(ids), p))(jnp.asarray(probs))
    pred = torch.tensor(probs, requires_grad=True)
    got = losses.mask_loss(torch.tensor(targets), torch.tensor(ids), pred)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    if positives:
        assert got.item() > 0
        _close(pred.grad.numpy(), np.asarray(jgrad), 1e-4)
    else:
        assert got.item() == 0.0 and not pred.grad.any()


def _assign_case(rng, b=2, r=12, g=3, hw=32, mini_hw=None):
    """Proposals jittered around the GT boxes, so about half are positive;
    GT masks are ellipses (full canvas) or blobs (mini-masks)."""
    lo = rng.uniform(0.05, 0.5, (b, g, 2))
    hi = lo + rng.uniform(0.2, 0.45, (b, g, 2))
    gt_boxes = np.concatenate([lo, hi], -1).astype(np.float32)
    gt_boxes[1, -1] = 0.0                            # a padding slot
    gt_ids = rng.randint(1, 4, (b, g)).astype(np.int32)
    gt_ids[1, -1] = 0
    pick = rng.randint(0, g, (b, r))
    jitter = rng.normal(0, 0.05, (b, r, 4))
    proposals = (np.take_along_axis(gt_boxes, pick[..., None], 1) + jitter).astype(np.float32)
    side = mini_hw or hw
    yy, xx = np.mgrid[:side, :side] / (side - 1)
    masks = np.zeros((b, side, side, g), bool)
    for i in range(b):
        for j in range(g):
            if mini_hw:      # a blob inside the GT box's own frame
                cy, cx = rng.uniform(0.3, 0.7, 2)
            else:
                cx, cy = (gt_boxes[i, j, :2] + gt_boxes[i, j, 2:]) / 2
            masks[i, :, :, j] = ((yy - cy) / 0.3) ** 2 + ((xx - cx) / 0.2) ** 2 < 1
    return proposals, gt_ids, gt_boxes, masks


@pytest.mark.parametrize("mini", [False, True], ids=["full_masks", "mini_masks"])
def test_assign_mask_targets_matches_jax(rng, mini):
    mask_shape = (8, 8)
    proposals, gt_ids, gt_boxes, masks = _assign_case(rng, mini_hw=16 if mini else None)
    want = jtarget.assign_mask_targets(jnp.asarray(proposals), jnp.asarray(gt_ids),
                                       jnp.asarray(gt_boxes), jnp.asarray(masks, jnp.float32),
                                       mask_shape, mini)
    got = target_assign.assign_mask_targets(torch.tensor(proposals), torch.tensor(gt_ids),
                                            torch.tensor(gt_boxes),
                                            torch.tensor(masks).float(), mask_shape, mini)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < (got[1].numpy() > 0).sum() < got[1].numel()     # positives and negatives
    agree = (got[2].numpy() == np.asarray(want[2])).mean()
    assert agree >= 0.999, agree
    assert got[2].sum() > 0
