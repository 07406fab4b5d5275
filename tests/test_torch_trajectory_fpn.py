"""The port's training loop against the JAX package's on the ResNet-50 + FPN
backbone, BatchNorm frozen (TRAIN_BN off): tests/test_torch_trajectory.py's
configuration (24 Shapes images at 64², batch 4, flip-only augmentation,
the loss warm-up and a cosine rate; its docstring has the method) with
BACKBONE "resnet50_fpn", for 2 epochs (12 steps). Both packages start from
the JAX `MaskYOLO("training", seed=0)` weights.

Where the two packages part, free-running. The batches are bit-equal at
every step, and the first three steps' losses are equal (measured: bit for
bit). From the fourth step on they part (measured, steps 4-12: 2.7e-6,
1.2e-4, 2.1e-4, 1.2e-3, 3.6e-4, 4.2e-3, 2.0e-4, 8.3e-4, 4.5e-3), so in the
first epoch. That is the network's own chaos, not a fault: the port
against itself, with its weights moved by a relative 1e-7 (one f32
rounding; two draws), parts the same way (step 4: 4.1e-6 / 9.7e-7, step 7:
5.9e-4 / 1.3e-4, step 12: 1.9e-3 / 5.4e-4; the second epoch's loss 1.9e-3
/ 5.4e-4 apart), within a few times of the gap to JAX. So the free-running
run holds only what precedes the parting: tests/test_torch_trajectory.py's
bounds (1e-3 on epoch losses) would not hold for the port against itself.

What is held beyond it, on JAX's own trajectory (teacher forcing, as with
TRAIN_BN in tests/test_torch_trajectory_train_bn.py): at the first step of
each epoch, the port's train step given JAX's weights, statistics, step
count and batch gives JAX's loss within rel 1e-5, the one-step bound with
BatchNorm frozen (tests/test_torch_fpn.py::test_train_step_matches_jax).
"""

import torch

from mask_yolo_tpu_torch import MaskYOLO
from mask_yolo_tpu_torch.data.prefetch import to_device
from mask_yolo_tpu_torch.train import state, trainer
from test_torch_trajectory import LR, TRAIN_IMAGES, TRAJ, configs, rel, train_both

EPOCHS = 2
STEPS_PER_EPOCH = TRAIN_IMAGES // TRAJ["BATCH_SIZE"]
FIRST_STEPS, FIRST_REL = 3, 1e-5     # free-running: the steps before the parting
STEP_REL = 1e-5                      # teacher-forced, BatchNorm frozen


def test_fpn_train_loop_matches_jax_until_it_parts_frozen_bn(tmp_path):
    """MaskYOLO.train of both packages on the FPN network, TRAIN_BN off:
    the batches at every step and the first steps' losses, free-running;
    the first step of each epoch on JAX's state."""
    starts = {e * STEPS_PER_EPOCH for e in range(EPOCHS)}
    jm, pm, _, _ = train_both(False, tmp_path, keep_states=starts, backbone="resnet50_fpn",
                              epochs=EPOCHS)
    assert len(jm.steps) == len(pm.steps) == EPOCHS * STEPS_PER_EPOCH
    assert [s["batch"] for s in pm.steps] == [s["batch"] for s in jm.steps]
    gaps = [rel(p["loss"], j["loss"]) for p, j in zip(pm.steps, jm.steps)]
    print("free-running step loss gaps", ["%.1e" % g for g in gaps])
    assert max(gaps[:FIRST_STEPS]) <= FIRST_REL

    cfg = configs(False, "resnet50_fpn")[1]()
    model = MaskYOLO("training", cfg, seed=0, device="cpu")
    tx = state.make_optimizer(LR, cfg, dict(model.net.named_parameters()),
                              total_steps=len(jm.steps))
    step = trainer.make_train_step(cfg, tx)
    forced = []
    for rec in (r for r in jm.steps if r["step"] in starts):
        model.load_jax_variables({"params": rec["params"], "batch_stats": rec["stats"]})
        st = state.create_train_state(model.net, tx)
        st.step = rec["step"]
        _, metrics = step(st, to_device(rec["data"], torch.device("cpu")))
        forced.append(rel(float(metrics["loss"]), rec["loss"]))
    print("teacher-forced loss gaps", forced)
    assert len(forced) == EPOCHS and max(forced) <= STEP_REL
