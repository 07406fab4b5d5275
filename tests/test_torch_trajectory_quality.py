"""The quality run of both packages over several epochs: the port's
`mask_yolo_tpu_torch.tools.quality_run.run` against the JAX package's
`tools/quality_run.py` (loaded by path and run in-process), from the same
weights, on tests/test_torch_trajectory.py's configuration (its docstring
has the bounds and the noise floors)."""

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mask_yolo_tpu_torch import MaskYOLO  # noqa: E402
from test_torch_trajectory import (AP_TOL, EPOCHS, LOSS_REL, SCORE_THRESHOLD,  # noqa: E402
                                   TRAIN_IMAGES, VAL_IMAGES, configs, jax_init, rel)
def test_quality_run_matches_the_jax_tool_over_epochs(tmp_path, monkeypatch):
    """tools/quality_run.py of both packages (the JAX one on
    test_torch_trajectory's config in place of ShapesConfig), TRAIN_BN off, from the same weights,
    with the AP callback every epoch: the per-epoch history, the epoch the
    callback picks and its AP trajectory, and the final metrics."""
    import mask_yolo_tpu.data.shapes as jax_shapes
    import mask_yolo_tpu_torch
    from mask_yolo_tpu_torch.tools import quality_run
    from test_torch_tools import run_jax_tool

    jcfg, pcfg = configs(False)
    init = jax_init(jcfg)

    class SameInit(MaskYOLO):
        """The port's facade starting training from the JAX initialisation."""

        def __init__(self, mode="inference", *args, **kw):
            super().__init__(mode, *args, **kw)
            if mode == "training":
                self.load_jax_variables(init)

    monkeypatch.setattr(jax_shapes, "ShapesConfig", jcfg)
    monkeypatch.setattr(mask_yolo_tpu_torch, "MaskYOLO", SameInit)
    argv = ["--train-images", str(TRAIN_IMAGES), "--val-images", str(VAL_IMAGES),
            "--eval-images", str(VAL_IMAGES), "--epochs", str(EPOCHS), "--batch-size", "4",
            "--augment-flip-only", "--eval-every", "1", "--num-overlays", "0",
            "--lr-schedule", "cosine", "--lr-warmup-steps", "4",
            "--score-threshold", str(SCORE_THRESHOLD)]
    run_jax_tool(monkeypatch, "quality_run", [*argv, "--out", str(tmp_path / "jax")])
    args = quality_run.parser().parse_args([*argv, "--out", str(tmp_path / "port"),
                                            "--device", "cpu"])
    got = quality_run.run(quality_run.run_config(args, pcfg), args)
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())

    def history(side):
        return [json.loads(line) for line in open(tmp_path / side / "ckpt" / "history.jsonl")]

    def picked(result):
        traj = result["ap_trajectory"]
        return traj[int(np.argmax([e["box_ap50"] for e in traj]))]["epoch"]

    jh, ph = history("jax"), history("port")
    print("history", [(j["loss"], p["loss"], j["val_loss"], p["val_loss"]) for j, p in zip(jh, ph)])
    print("ap", want["ap_trajectory"], got["ap_trajectory"])
    print({k: (want[k], got[k]) for k in ("box_ap50", "mask_ap50", "int8_box_ap50")})
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == list(range(1, EPOCHS + 1))
    for j, p in zip(jh, ph):
        assert rel(p["loss"], j["loss"]) <= LOSS_REL and rel(p["val_loss"], j["val_loss"]) <= LOSS_REL
    assert picked(got) == picked(want)
    for j, p in zip(want["ap_trajectory"], got["ap_trajectory"]):
        assert j["epoch"] == p["epoch"]
        assert abs(p["box_ap50"] - j["box_ap50"]) <= AP_TOL
        assert abs(p["mask_ap50"] - j["mask_ap50"]) <= AP_TOL
    for k in ("box_ap50", "mask_ap50", "box_map", "mask_map", "best_epoch_box_ap50"):
        assert abs(got[k] - want[k]) <= AP_TOL, k
