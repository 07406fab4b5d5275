"""The port's ResNet-50 + FPN training step with BatchNorm on batch
statistics (TRAIN_BN, as ShapesConfig trains) against the JAX package's, on
the JAX step's own states (teacher forcing, the method of
tests/test_torch_trajectory_train_bn.py): JAX's `trainer.make_train_step`
runs 3 steps from flax's init at tests/test_torch_fpn.py's FpnTiny (64²,
batch 2, mini-masks, MASK_TRAIN_TOP_ROIS 4) on the Shapes targets over
seeded noise images (tests/test_torch_train.py's batches); before each, the
port's `trainer.make_train_step` is given JAX's weights, statistics, step
count and batch, and its loss and running statistics after the step are held
to JAX's.

Why the bounds differ by part of the network. The ResNet-50 trunk at 64²
puts C5 at 2×2, and the YOLO head runs on it: those BatchNorms normalise
each channel over 8 samples, after 53 train-mode BatchNorms whose
variance, E[x²] − E[x]² in f32 as flax computes it, cancels where a deep
channel barely varies across the batch. f32 rounding is amplified there
about 10⁴-fold, so the heads and the loss are chaotic at this point:
  * The port against itself (measured, step 0): with the batch reversed,
    loss 1.1e-3 apart, statistics 2.4e-3 of a leaf's max; with its weights
    moved by a relative 1e-7 (one f32 rounding), loss up to 3.8e-3 and
    statistics up to 3.9e-3 apart. The one-step bounds of
    tests/test_torch_trajectory.py (loss 5e-4, statistics 1e-3), which hold
    for the MobileNet network, are below this floor.
  * Against JAX (measured): loss 4.8e-3 / 3.4e-5 / 2.0e-3 at steps 0 / 1 /
    2, statistics 1.2e-2 / 4.5e-3 / 8.7e-4, the largest in the YOLO head's
    last block and the mask head. The gap grows smoothly with depth from the
    stem (2.5e-6) with no layer where it jumps. Against a float64
    evaluation of the port's trunk and YOLO loss (its convolutions and
    BatchNorms run in float64), the port's f32 step is 3.6e-4 (loss) and
    2.3e-3 (statistics) away, JAX's f32 step 5.2e-3 and 1.3e-2: JAX's f32
    BatchNorm is the noisier of the two (XLA's f32 CPU reductions, as
    tests/test_torch_train.py's docstring says). With flax's BatchNorm in
    float64 too (JAX's x64 mode, which this suite cannot switch on: it is
    process-wide), JAX comes within 3.9e-5 (loss) and 3.8e-4 (statistics)
    of the port's float64 evaluation at batch 8, against 3.5e-3 and 3.6e-3
    in f32: the two packages compute the same step. (Measured once, not in
    this suite.)
So the backbone (ResNet-50 and FPN: 53 BatchNorms, where the gap is at most
4.5e-4) is held at the one-step limit STATS_REL (1e-3); the heads' statistics
and the loss, downstream of the amplification, within HEAD_REL (3e-2: 2.5x
the largest gap to JAX measured at the three steps, 1.17e-2, and 8x the
port's own floor). A fault of BatchNorm's semantics is far outside it:
torch's momentum 0.1 in place of flax's 0.99 moves every statistic of the
first step 10-fold, and the unbiased variance of nn.BatchNorm2d moves the
heads' variances by 14 %. The raw gradient is not held: it is
ill-conditioned here (cosine 0.9967 to itself on the batch reversed,
tests/test_torch_fpn.py).

The neck (one 3×3 conv, no BatchNorm, read by nothing on the FPN path) has
no statistics in either package, gets no gradient in the port and a zero
one in JAX, and stays where it was in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_yolo_tpu.train import state as jstate
from mask_yolo_tpu.train import trainer as jtrainer
from mask_yolo_tpu_torch import MaskYOLO, weights
from mask_yolo_tpu_torch.train import state, trainer
from test_torch_fpn import FpnTiny, jax_net
from test_torch_train import batches, port_config
from test_torch_trajectory import STATS_REL, leaf_gap, rel

torch.set_num_threads(2)

STEPS, LR = 3, 1e-3
HEAD_REL = 3e-2          # the YOLO and mask heads' statistics, and the loss (docstring)


class FpnTrainBn(FpnTiny):
    TRAIN_BN = True
    USE_MINI_MASK = True
    MASK_TRAIN_TOP_ROIS = 4


def host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's 3 steps from flax's init: for each, the batch, the state before
    it, its loss and mask loss, and the statistics after it; and the neck's
    kernel before and after all three."""
    jcfg = FpnTrainBn()
    net = jax_net(jcfg)
    v = host(jax.jit(lambda r: net.init(r, jnp.zeros((2, *jcfg.IMAGE_SHAPE)),
                                        jnp.zeros((2, 8, 4)), train=False))(jax.random.PRNGKey(0)))
    gen = batches(port_config(jcfg), count=2 * STEPS)
    tx = jstate.make_optimizer(LR, jcfg)
    st = jstate.create_train_state(jax.tree_util.tree_map(jnp.array, v["params"]),
                                   jax.tree_util.tree_map(jnp.array, v["batch_stats"]), tx)
    step = jtrainer.make_train_step(net, jcfg, tx)
    recs = []
    for i in range(STEPS):
        rec = {"data": gen[i], "params": host(st.params), "stats": host(st.batch_stats),
               "step": int(st.step)}
        st, metrics = step(st, {k: jnp.asarray(x) for k, x in gen[i].items()})
        rec.update(loss=float(metrics["loss"]), mask_loss=float(metrics["myolo_mask_loss"]),
                   stats_after=host(st.batch_stats))
        recs.append(rec)
    neck = (v["params"]["feature_map"]["kernel"], host(st.params)["feature_map"]["kernel"])
    return recs, neck


@pytest.fixture(scope="module")
def port():
    cfg = port_config(FpnTrainBn())
    model = MaskYOLO("training", cfg, seed=0, device="cpu")
    tx = state.make_optimizer(LR, cfg, dict(model.net.named_parameters()))
    return model, tx, trainer.make_train_step(cfg, tx)


def port_step(port, rec):
    """The port's step on JAX's state before `rec`: (loss, mask loss, flax
    batch_stats after it, the neck's gradient and weight before and after)."""
    model, tx, step = port
    model.load_jax_variables({"params": rec["params"], "batch_stats": rec["stats"]})
    neck = model.net.feature_map.weight.detach().clone()
    st = state.create_train_state(model.net, tx)
    st.step = rec["step"]
    model.net.train()
    st, metrics = step(st, {k: torch.from_numpy(v) for k, v in rec["data"].items()})
    stats = weights.to_jax_variables(
        {k: b.detach().numpy() for k, b in model.net.named_buffers() if "running" in k})
    return (float(metrics["loss"]), float(metrics["myolo_mask_loss"]), stats["batch_stats"],
            (model.net.feature_map.weight.grad, neck, model.net.feature_map.weight.detach()))


@pytest.mark.parametrize("i", range(STEPS))
def test_teacher_forced_step_matches_jax(jax_steps, port, i):
    """Step i of JAX's run, by the port on JAX's state: the loss and the
    heads' statistics within HEAD_REL, the backbone's within STATS_REL."""
    rec = jax_steps[0][i]
    loss, mask_loss, stats, _ = port_step(port, rec)
    want = rec["stats_after"]
    backbone = leaf_gap(stats["backbone"], want["backbone"])
    heads = max(leaf_gap(stats[k], want[k]) for k in ("yolo", "mask"))
    gap = rel(loss, rec["loss"])
    print(f"step {i}: loss {gap:.2e}, backbone statistics {backbone:.2e}, heads {heads:.2e}, "
          f"mask loss {mask_loss:.4f} (JAX {rec['mask_loss']:.4f})")
    assert sorted(stats) == sorted(want)
    assert backbone <= STATS_REL and heads <= HEAD_REL and gap <= HEAD_REL


def test_mask_branch_is_exercised_and_the_neck_stays(jax_steps, port):
    """The mask loss is positive at some step in both packages; the neck has
    no BatchNorm in either, gets no gradient in the port and does not move
    in either."""
    recs, (neck_before, neck_after) = jax_steps
    assert any(r["mask_loss"] > 0 for r in recs)
    np.testing.assert_array_equal(neck_after, neck_before)
    assert "feature_map" not in recs[0]["stats"]
    model = port[0]
    assert not [k for k, _ in model.net.named_buffers() if k.startswith("feature_map.")]
    i = next(i for i, r in enumerate(recs) if r["mask_loss"] > 0)
    _, mask_loss, _, (grad, before, after) = port_step(port, recs[i])
    assert mask_loss > 0 and grad is None and torch.equal(after, before)
