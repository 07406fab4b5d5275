"""The port's `tools.bench_export` and `tools.ab_infer_yolo_exactness` on
the CPU at TinyConfig size, against the JAX package (see
tests/test_torch_measure_tools.py for the rules these tests follow):
bench_export's `compute_path` against the JAX export header's and its
artifact against live bit for bit; ab_infer_yolo_exactness's whole JSON
against the JAX tool's, run (with --cpu) from its file on the same
checkpoint and COCO directory."""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mask_yolo_tpu_torch import MaskYOLO  # noqa: E402
from mask_yolo_tpu_torch.config import CocoStyleConfig  # noqa: E402
from mask_yolo_tpu_torch.tools import ab_infer_yolo_exactness, bench_export  # noqa: E402
from test_torch_measure_stages import assert_rows_carry_jax_keys, jax_json_keys  # noqa: E402
from test_torch_measure_tools import WIDTHS, TinyCoco, printed_rows  # noqa: E402
from test_torch_quant import spread_variables  # noqa: E402
from test_torch_tools import run_jax_tool  # noqa: E402

torch.set_num_threads(2)


def test_bench_export_prints_the_jax_rows(capsys, monkeypatch):
    """Both flavors: the artifact equals the live path bit for bit, and the
    header's compute_path is the JAX export's (config.COMPUTE_DTYPE for the
    float network, mask_yolo_tpu/export.py:61; "int8" after quantize,
    mask_yolo_tpu/model.py:401)."""
    monkeypatch.setattr(bench_export, "run_config",
                        lambda args, base=None, f=bench_export.run_config: f(args, TinyCoco))
    rows = bench_export.main(["--batch", "2", "--device", "cpu"])
    assert printed_rows(capsys) == rows
    assert_rows_carry_jax_keys(rows, jax_json_keys("bench_export"))
    assert [(r["flavor"], r["compute_path"]) for r in rows] == [
        ("bf16", TinyCoco.COMPUTE_DTYPE), ("int8", "int8")]
    assert all(r["outputs_equal"] and r["artifact_vs_live"] > 0 for r in rows)


# ---------------------------------------------------------------------------
# ab_infer_yolo_exactness against the JAX tool
# ---------------------------------------------------------------------------


def test_ab_infer_yolo_exactness_json_equals_the_jax_tool(tmp_path, monkeypatch):
    """Both tools on 4 Shapes images written as a COCO directory and the
    same 4-class weights (JAX: an orbax save_weights; the port: its .pt of
    the same variables), on CocoStyleConfig with TinyConfig's widths (the
    JAX tool's config patched in place) in f32: the reports are equal. (In
    bf16 each package rounds the trunk its own way, which can move a class
    probability across OBJ_THRESHOLD and so a count by one.)"""
    import mask_yolo_tpu.config as jax_config
    from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO
    from mask_yolo_tpu_torch.data.coco import dataset_to_coco_json
    from mask_yolo_tpu_torch.data.shapes import ShapesDataset

    ds = ShapesDataset()
    ds.load_shapes(4, 64, 64, seed=5)
    ds.prepare()
    dataset_to_coco_json(ds, str(tmp_path / "coco"))
    v, _, _ = spread_variables()
    f32 = {**WIDTHS, "COMPUTE_DTYPE": "float32"}
    jax_tiny = type("JaxCoco", (jax_config.CocoStyleConfig,), f32)
    monkeypatch.setattr(jax_config, "CocoStyleConfig", jax_tiny)
    jm = JaxMaskYOLO("inference", type("J4", (jax_tiny,), {"NUM_CLASSES": 4})())
    jm.params, jm.batch_stats = v["params"], v["batch_stats"]
    jm.save_weights(str(tmp_path / "jax_w"))
    argv = ["--data", str(tmp_path / "coco"), "--num-classes", "3", "--k", "2", "3",
            "--top-n", "4", "--cpu"]
    run_jax_tool(monkeypatch, "ab_infer_yolo_exactness",
                 ["--weights", str(tmp_path / "jax_w"), *argv, "--out",
                  str(tmp_path / "jax.json")])
    args = ab_infer_yolo_exactness.parser().parse_args(
        ["--weights", str(tmp_path / "port.pt"), *argv, "--out", str(tmp_path / "port.json")])
    cfg = ab_infer_yolo_exactness.run_config(args, type("C", (CocoStyleConfig,), f32))
    port = MaskYOLO("inference", cfg, device="cpu")
    port.load_jax_variables(v)
    port.save_weights(str(tmp_path / "port.pt"))
    report = ab_infer_yolo_exactness.run(cfg, args)
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == report == want
    assert report["n_images"] == 4 and report["max_boxes_per_class"] > 0
    assert set(report) == {"n_images", "max_boxes_per_class", "p99_boxes_per_class",
                           "k2", "k3", "topn4"}
