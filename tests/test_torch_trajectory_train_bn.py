"""The port's training loop against the JAX package's over several epochs
with BatchNorm on batch statistics (TRAIN_BN, ShapesConfig's setting), on
tests/test_torch_trajectory.py's configuration: its docstring has why
every step is held on the JAX loop's own states, the bounds and the noise
floors."""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mask_yolo_tpu.train import state as jstate  # noqa: E402
from mask_yolo_tpu_torch import MaskYOLO, weights  # noqa: E402
from mask_yolo_tpu_torch.data.pipeline import BatchGenerator, preload_dataset  # noqa: E402
from mask_yolo_tpu_torch.data.prefetch import to_device  # noqa: E402
from mask_yolo_tpu_torch.data.shapes import ShapesDataset  # noqa: E402
from mask_yolo_tpu_torch.train import state, trainer  # noqa: E402
from test_torch_trajectory import (LR, STATS_REL, STEP_LOSS_REL, configs,  # noqa: E402
                                   datasets, leaf_gap, rel, train_both)


def test_train_loop_matches_jax_over_epochs_train_bn(tmp_path):
    """MaskYOLO.train of both packages, TRAIN_BN on: the batches of the two
    free-running loops, and every step of the port on the JAX loop's states."""
    jcfg, pcfg = configs(True)
    jm, pm, jepochs, _ = train_both(True, tmp_path, keep_states=True)
    assert [s["batch"] for s in pm.steps] == [s["batch"] for s in jm.steps]
    assert rel(pm.steps[0]["loss"], jm.steps[0]["loss"]) <= STEP_LOSS_REL

    cfg = pcfg()
    model = MaskYOLO("training", cfg, seed=0, device="cpu")
    tx = state.make_optimizer(LR, cfg, dict(model.net.named_parameters()),
                              total_steps=len(jm.steps))
    jtx_lr = jstate.make_lr_schedule(LR, jcfg(), total_steps=len(jm.steps))
    for count in range(len(jm.steps) + 1):
        assert abs(tx.lr(count) - float(jtx_lr(count))) <= 1e-6 * LR, count   # optax: f32
    step = trainer.make_train_step(cfg, tx)
    loss_gaps, stats_gaps = [], []
    for rec in jm.steps:
        model.load_jax_variables({"params": rec["params"], "batch_stats": rec["stats"]})
        st = state.create_train_state(model.net, tx)
        st.step = rec["step"]
        model.net.train()
        st, metrics = step(st, to_device(rec["data"], torch.device("cpu")))
        loss_gaps.append(rel(float(metrics["loss"]), rec["loss"]))
        model._sync_host_state()
        stats = weights.to_jax_variables(model._host_state)["batch_stats"]
        stats_gaps.append(leaf_gap(stats, rec["stats_after"]))
    print("teacher-forced loss gaps", ["%.1e" % g for g in loss_gaps], "stats gaps", max(stats_gaps))
    assert max(loss_gaps) <= STEP_LOSS_REL and max(stats_gaps) <= STATS_REL

    _, val_ds = datasets(ShapesDataset)
    val_gen = BatchGenerator(preload_dataset(val_ds, cfg), cfg, mode="training", shuffle=False)
    eval_step = trainer.make_eval_step(cfg)
    val_gaps = []
    for rec in jepochs:
        model.load_jax_variables({"params": rec["params"], "batch_stats": rec["stats"]})
        model.net.eval()
        st = state.create_train_state(model.net, tx)
        val = np.mean([float(eval_step(st, to_device(val_gen[i], torch.device("cpu")))["loss"])
                       for i in range(len(val_gen))])
        val_gaps.append(rel(val, rec["val_loss"]))
    print("teacher-forced val gaps", val_gaps)
    assert max(val_gaps) <= STEP_LOSS_REL

