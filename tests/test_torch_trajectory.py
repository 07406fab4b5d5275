"""The port's training loop against the JAX package's over several epochs,
f32, at TinyConfig widths with the Shapes labels: 24 Shapes images, batch 4
(6 steps an epoch), 4 epochs, flip-only augmentation
(`augment.Sequential([Fliplr(0.5)], seed=7)`, the quality run's), seed 0,
the YOLO loss warm-up over the first 8 steps (WARM_UP_BATCHES, so it ends
inside epoch 2) and a cosine rate with 4 warm-up steps (read at the
update count). Both packages start from the same weights: the JAX
`MaskYOLO("training", seed=0)` initialisation, bridged by
`weights.from_jax_variables`.

Two loops of each package: `MaskYOLO.train`, and the quality run
(`tools/quality_run.py` of the JAX package, loaded by path and run
in-process, against `mask_yolo_tpu_torch.tools.quality_run.run`) with the
AP callback every epoch.

What is held, and why these bounds. The one-step limits
(tests/test_torch_train.py) are a loss within rel 1e-5 (BatchNorm on running
statistics) or 1e-4 (TRAIN_BN, on noise images), gradients within 1e-4 of
each leaf's max. Past one step the trajectory itself sets the limit:
  * TRAIN_BN off. At a constant lr of 1e-3 the two packages' step losses
    agree to 1.5e-7 for 3 steps, then part at about x2.5 a step (8e-6 at
    step 6, 2e-4 at 12, 8e-3 at 20). The noise floor is the port against
    itself: with each batch's samples permuted it stays within 1.1e-7 for
    all 24 steps (its summation order barely moves), but with its initial
    weights moved by a relative 1e-7 (about one f32 rounding) it parts at
    the same rate, to 1.2e-3 at step 10 and 2-3e-2 at steps 23-24, wider
    than the gap to JAX. So that gap is rounding amplified by training.
    With this module's warm-up and cosine rate the steps stay close:
    measured, every step's loss within 6.9e-6, each epoch's training loss
    (the last step's, as the callbacks see it) within 3.7e-6 and its
    validation loss within 4.1e-6 (bound rel 1e-3 on both, the issue's).
    Adam moves an entry whose gradient is ~0 by about lr a step in the sign
    of its rounding noise, so a few entries part by a few lr while the tree
    does not: final parameters 4.1e-4 apart in norm (bound 1e-3), 4.7e-3 at
    the worst entry (bound 8 lr = 8e-3; 8 of block2's 4,096 pointwise
    entries and 312 of mask_conv4's 589,824 are past 1e-3). The port
    against itself with weights moved by 1e-7: 2.4e-4 in norm, 1.6e-3 at
    the worst entry, every step's loss within 8.0e-6.
  * TRAIN_BN on (ShapesConfig's setting). The gradient is ill-conditioned
    at TinyConfig: the port against itself with each batch's samples
    permuted is 0.9 % apart at step 2 and up to 50 % by step 4, so no bound
    on a free-running trajectory can hold. The test holds every step of the
    loop instead, on the JAX loop's own states (teacher forcing): at each
    of the 24 steps the port's train step, given JAX's weights, BatchNorm
    statistics and step count before that step and its batch, gives JAX's
    loss (measured 1.5e-4 at worst; bound 5e-4: these are flat Shapes
    images, on which XLA's f32 variance is off by up to 0.7 %, where the
    one-step test's 1e-4 is on noise images) and JAX's running statistics
    after it (3.0e-4 of a leaf's max; bound 1e-3, the one-step limit), and
    at each epoch's end the port's validation loss on JAX's state is JAX's
    (3.1e-8; bound 5e-4). The learning rate agrees at every count (rel
    1e-6: optax computes it in f32).
In both settings the batches are bit-equal at every step, so the
epoch-to-epoch shuffle and the flip draws of the two packages are the same
stream, and the step counter that drives the loss warm-up is the same.

The TRAIN_BN test is tests/test_torch_trajectory_train_bn.py. The quality
runs (TRAIN_BN off; tests/test_torch_trajectory_quality.py) write the same
per-epoch history
(ckpt/history.jsonl: loss and val_loss within 4e-6, bound rel 1e-3), the AP
callback picks the same epoch (2) with the same AP trajectory (equal here;
bound 0.02, one detection's worth of 8 images), and the final metrics
agree. At TinyConfig after 4 epochs the APs are near 0 (<= 0.003): this
holds the loop and the callback's choice, not a trained detector.

Nothing parts, so the gap between the port's Shapes AP50 and the JAX
figure at the quality run's budget is not a fault of the training loop
(PERF.md, ROADMAP Queue 3).
"""

import hashlib
import sys
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from conftest import TinyConfig  # noqa: E402
from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO  # noqa: E402
from mask_yolo_tpu.data import augment as jaugment  # noqa: E402
from mask_yolo_tpu.data.shapes import ShapesDataset as JaxShapesDataset  # noqa: E402
from mask_yolo_tpu_torch import MaskYOLO, weights  # noqa: E402
from mask_yolo_tpu_torch.config import Config  # noqa: E402
from mask_yolo_tpu_torch.data import augment  # noqa: E402
from mask_yolo_tpu_torch.data.shapes import ShapesDataset  # noqa: E402
from test_torch_parallel import TINY  # noqa: E402

torch.set_num_threads(2)

TRAIN_IMAGES, VAL_IMAGES, EPOCHS, LR = 24, 8, 4, 1e-3
TRAJ = dict(TINY, NUM_CLASSES=4, LABELS=["background", "square", "circle", "triangle"],
            BATCH_SIZE=4, USE_MINI_MASK=True, MINI_MASK_SHAPE=(16, 16), MASK_TRAIN_TOP_ROIS=4,
            WARM_UP_BATCHES=8, LR_SCHEDULE="cosine", LR_WARMUP_STEPS=4, MAX_CHECKPOINTS=1)
LOSS_REL, PARAM_REL = 1e-3, 1e-3          # free-running, TRAIN_BN off
ENTRY_ABS = 8 * LR                        # one entry (Adam moves a ~0-gradient one ~lr a step)
SCORE_THRESHOLD, AP_TOL = 0.35, 0.02     # the quality run's threshold; one detection of 8 images
STEP_LOSS_REL, STATS_REL = 5e-4, 1e-3     # teacher-forced, TRAIN_BN on (Shapes images)


def configs(train_bn, backbone="mobilenet"):
    fields = dict(TRAJ, TRAIN_BN=train_bn, BACKBONE=backbone)
    return type("JaxTraj", (TinyConfig,), fields), type("PortTraj", (Config,), fields)


def datasets(cls):
    out = []
    for count, seed in ((TRAIN_IMAGES, 0), (VAL_IMAGES, 1)):
        ds = cls()
        ds.load_shapes(count, 64, 64, seed=seed)
        ds.prepare()
        out.append(ds)
    return out


def fingerprint(batch):
    """A digest of every array of a batch (the same bytes in both packages)."""
    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(batch[k])).tobytes())
    return h.hexdigest()


def host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def jax_init(jcfg):
    model = JaxMaskYOLO("training", jcfg(), seed=0)   # nothing is written before train()
    return {"params": host(model.params), "batch_stats": host(model.batch_stats)}


class RecordingJax(JaxMaskYOLO):
    """The JAX facade with each train step recorded: the batch, the state
    before it (when `keep_states`: True, or a set of step counts), the loss
    and the statistics after it."""

    keep_states = False

    def compile(self, *args, **kw):
        super().compile(*args, **kw)
        step = self._train_step
        self.steps = []

        def recorded(st, batch):
            rec = {"batch": fingerprint(host(batch)), "step": int(st.step)}
            keep = self.keep_states
            if keep is True or (keep and rec["step"] in keep):
                rec.update(params=host(st.params), stats=host(st.batch_stats), data=host(batch))
            st, metrics = step(st, batch)
            rec.update(loss=float(metrics["loss"]), stats_after=host(st.batch_stats))
            self.steps.append(rec)
            return st, metrics

        self._train_step = recorded


class RecordingPort(MaskYOLO):
    def compile(self, *args, **kw):
        super().compile(*args, **kw)
        step = self._train_step
        self.steps = []

        def recorded(st, batch):
            rec = {"batch": fingerprint({k: v.cpu().numpy() for k, v in batch.items()}),
                   "step": int(st.step)}
            st, metrics = step(st, batch)
            rec["loss"] = float(metrics["loss"])
            self.steps.append(rec)
            return st, metrics

        self._train_step = recorded


def train_both(train_bn, tmp_path, keep_states=False, backbone="mobilenet", epochs=EPOCHS):
    jcfg, pcfg = configs(train_bn, backbone)
    v = jax_init(jcfg)
    jepochs, pepochs = [], []

    jm = RecordingJax("training", jcfg(), model_dir=str(tmp_path / "jax"), seed=0)
    jm.keep_states = keep_states
    jm.train(*datasets(JaxShapesDataset), LR, epochs, verbose=False,
             augmentation=jaugment.Sequential([jaugment.Fliplr(0.5)], seed=7),
             custom_callbacks=[lambda e, m, vl, s: jepochs.append(
                 {"loss": float(m["loss"]), "val_loss": vl,
                  "params": host(s.params), "stats": host(s.batch_stats)})])

    pm = RecordingPort("training", pcfg(), model_dir=str(tmp_path / "port"), seed=0,
                       device="cpu")
    pm.load_jax_variables(v)
    pm.train(*datasets(ShapesDataset), LR, epochs, verbose=False,
             augmentation=augment.Sequential([augment.Fliplr(0.5)], seed=7),
             custom_callbacks=[lambda e, m, vl, s: pepochs.append(
                 {"loss": float(m["loss"]), "val_loss": vl})])
    return jm, pm, jepochs, pepochs


def leaf_pairs(got, want):
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        yield np.asarray(got[path]), np.asarray(w)


def leaf_gap(got, want):
    """max over leaves of max|got - want| / max|want|."""
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
               for g, w in leaf_pairs(got, want))


def param_gaps(got, want):
    """(|got - want| / |want| over the whole tree, the largest |got - want|
    of one entry)."""
    pairs = list(leaf_pairs(got, want))
    d = np.sqrt(sum(float(np.sum((g - w) ** 2)) for g, w in pairs))
    n = np.sqrt(sum(float(np.sum(w ** 2)) for _, w in pairs))
    return d / n, max(float(np.abs(g - w).max()) for g, w in pairs)


def rel(a, b):
    return abs(a - b) / abs(b)


def test_train_loop_matches_jax_over_epochs_frozen_bn(tmp_path):
    """MaskYOLO.train of both packages, TRAIN_BN off, free-running."""
    jm, pm, jepochs, pepochs = train_both(False, tmp_path)
    steps = EPOCHS * (TRAIN_IMAGES // TRAJ["BATCH_SIZE"])
    assert len(jm.steps) == len(pm.steps) == steps
    assert [s["batch"] for s in pm.steps] == [s["batch"] for s in jm.steps]
    assert [s["step"] for s in pm.steps] == [s["step"] for s in jm.steps] == list(range(steps))
    gaps = [rel(p["loss"], j["loss"]) for p, j in zip(pm.steps, jm.steps)]
    print("step loss gaps", ["%.1e" % g for g in gaps])
    epoch_gaps = [rel(p["loss"], j["loss"]) for p, j in zip(pepochs, jepochs)]
    val_gaps = [rel(p["val_loss"], j["val_loss"]) for p, j in zip(pepochs, jepochs)]
    params = weights.to_jax_variables(pm._host_state)["params"]
    tree, entry = param_gaps(params, jepochs[-1]["params"])
    print("epoch loss gaps", epoch_gaps, "val gaps", val_gaps, "params", tree, entry)
    assert len(pepochs) == len(jepochs) == EPOCHS
    assert max(epoch_gaps) <= LOSS_REL and max(val_gaps) <= LOSS_REL
    assert tree <= PARAM_REL and entry <= ENTRY_ABS

