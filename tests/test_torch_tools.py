"""The port's command-line tools (mask_yolo_tpu_torch/tools, bench.py) on the
CPU at TinyConfig size, each with `--device cpu`, and against the JAX
package's tools where both compute the same thing.

predict. The JAX `tools/predict.py` is loaded by path and run in-process
(JAX on the CPU) on the same PNGs and weights: JAX reads an orbax
checkpoint from its `save_weights`, the port its own checkpoint of the same
variables (`weights.from_jax_variables`). The weights are
test_torch_slice's spread tree (random BatchNorm statistics, a scaled
`mask_out`: at plain init every mask probability sits at 0.5 ± 1e-4) with
test_torch_quant's random deconv kernel. The JAX int8 graph reads that
kernel unflipped (ROADMAP Queue 3), so for --quantize JAX gets the tree with
it flipped beforehand. The COCO results must agree entry for entry: image
and category ids equal, scores within 1e-5, boxes within 1e-3 px, decoded
RLE masks on >= 99.9 % of the pixels.

--mesh: two gloo ranks, each detecting its share of every batch, write the
JSON of one process. The rank workers live in this file's `__main__`
block (`python tests/test_torch_tools.py mesh <workdir>`, the MYOLO_*
variables set): they import torch and the port, never JAX; each has a
timeout.
"""

import ast
import io
import json
import os
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mask_yolo_tpu_torch import MaskYOLO, bench  # noqa: E402
from mask_yolo_tpu_torch.config import CocoStyleConfig, Config  # noqa: E402
from mask_yolo_tpu_torch.data.coco import rle_decode_counts  # noqa: E402
from mask_yolo_tpu_torch.data.shapes import ShapesDataset  # noqa: E402
from mask_yolo_tpu_torch.tools import (ab_infer_yolo_exactness, bench_416,  # noqa: E402
                                       bench_export, bench_roofline, bench_train, eval_int8,
                                       export_model, gen_anchors, materialize_textured,
                                       predict, profile_infer_yolo, profile_layers_416,
                                       profile_stages, profile_stages_416, quality_run,
                                       quality_run_coco, serve_model)

torch.set_num_threads(2)

from test_torch_parallel import TINY  # noqa: E402  (TinyConfig's values, no conftest)

# the Shapes labels on TinyConfig's widths, for the tools that train on Shapes
SHAPES_TINY = dict(TINY, NUM_CLASSES=4, LABELS=["background", "square", "circle", "triangle"])
N_IMAGES, BATCH = 5, 4            # two batches, the last one padded
TIMEOUT_S = 150
WORKER = os.path.abspath(__file__)
SCORE_TOL, BOX_TOL_PX, MASK_AGREE = 1e-5, 1e-3, 0.999


def tiny(base=Config, **over):
    return type("PortTiny", (base,), {**TINY, **over})()


def predict_argv(workdir, weights, out, *extra):
    return ["--weights", str(weights), "--config-json", str(workdir / "config.json"),
            "--images", str(workdir / "images"), "--out", str(out),
            "--batch-size", str(BATCH), "--score-threshold", "0", *extra]


def write_images(directory, count, size, seed):
    """Seeded Shapes scenes as PNG files 0.png, 1.png, ..."""
    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    ds = ShapesDataset()
    ds.load_shapes(count, size, size, seed=seed)
    ds.prepare()
    for i in ds.image_ids:
        Image.fromarray(ds.load_image(i)).save(directory / f"{i}.png")


def assert_same_results(got, want):
    """Two COCO results lists, entry for entry, at the module's bounds."""
    assert len(got) == len(want) > 0
    agree = []
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= SCORE_TOL, (g["score"], w["score"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=BOX_TOL_PX)
        shape = tuple(w["segmentation"]["size"])
        assert tuple(g["segmentation"]["size"]) == shape
        agree.append(np.mean(rle_decode_counts(g["segmentation"]["counts"], shape)
                             == rle_decode_counts(w["segmentation"]["counts"], shape)))
    print(f"{len(got)} detections; masks agree on {min(agree):.6f} of pixels at worst")
    assert min(agree) >= MASK_AGREE


def load_jax_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_tool(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    load_jax_tool(name).main()


# ---------------------------------------------------------------------------
# rank workers (no JAX)
# ---------------------------------------------------------------------------


def worker_mesh(workdir):
    workdir = Path(workdir)
    predict.main(predict_argv(workdir, workdir / "port.pt", workdir / "mesh.json",
                              "--mesh", "--device", "cpu"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(case, n, workdir):
    """Run `case` on n gloo ranks; every rank must exit 0 within TIMEOUT_S."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MYOLO_COORDINATOR=f"localhost:{port}",
                   MYOLO_NUM_PROCESSES=str(n), MYOLO_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        log = open(workdir / f"{case}{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, case, str(workdir)], env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                if proc.wait(timeout=TIMEOUT_S) != 0:
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = [(workdir / f"{case}{r}.log").read_text()[-3000:] for r in failed]
        pytest.fail(f"ranks {failed} of {case} failed:\n" + "\n---\n".join(logs))


# ---------------------------------------------------------------------------
# predict against the JAX tool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predict_setup(tmp_path_factory):
    """PNGs, a config.json of TinyConfig with the Shapes labels, and the weights:
    JAX's orbax checkpoints (float, and the deconv-flipped tree for int8)
    and the port's checkpoint of the same variables."""
    from conftest import TinyConfig
    from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO
    from test_torch_quant import spread_variables

    workdir = tmp_path_factory.mktemp("predict")
    write_images(workdir / "images", N_IMAGES, 64, seed=3)
    (workdir / "config.json").write_text(json.dumps(SHAPES_TINY))
    v, vf, _ = spread_variables()   # a 4-class head: SHAPES_TINY's
    jm = JaxMaskYOLO("inference", type("JaxTiny", (TinyConfig,), SHAPES_TINY)())
    for name, tree in (("jax_float", v), ("jax_int8", vf)):
        jm.params, jm.batch_stats = tree["params"], tree["batch_stats"]
        jm.save_weights(str(workdir / name))
    port = MaskYOLO("inference", tiny(**SHAPES_TINY), device="cpu")
    port.load_jax_variables(v)
    port.save_weights(str(workdir / "port.pt"))
    return workdir


def _tiny_shapes(count, size, seed=0):
    ds = ShapesDataset()
    ds.load_shapes(count, size, size, seed=seed)
    ds.prepare()
    return ds


@pytest.mark.parametrize("path", ["float", "int8"])
def test_predict_matches_the_jax_tool(predict_setup, monkeypatch, path):
    """tools/predict.py of both packages on the same 5 PNGs (two batches of
    4, the last padded) and weights, float and --quantize (calibrated on
    the first batch, chained int8 layers in both)."""
    workdir = predict_setup
    extra = ["--quantize"] if path == "int8" else []
    run_jax_tool(monkeypatch, "predict",
                 predict_argv(workdir, workdir / f"jax_{path}", workdir / f"jax_{path}.json",
                              *extra))
    out = workdir / f"port_{path}.json"
    args = predict.parser().parse_args(predict_argv(workdir, workdir / "port.pt", out,
                                                    "--device", "cpu", *extra))
    results = predict.run(predict.build_config(args), args)
    assert json.loads(out.read_text()) == results
    assert_same_results(results, json.loads((workdir / f"jax_{path}.json").read_text()))
    assert {r["image_id"] for r in results} <= set(range(N_IMAGES))


def test_predict_on_two_gloo_ranks_equals_one_process(predict_setup, tmp_path):
    """--mesh on two gloo ranks (each detects 2 of every batch of 4) writes
    the JSON of one process, bit for bit; a world of one (no job) too."""
    workdir = predict_setup
    want = predict.main(predict_argv(workdir, workdir / "port.pt", tmp_path / "one.json",
                                     "--device", "cpu"))
    alone = predict.main(predict_argv(workdir, workdir / "port.pt", tmp_path / "alone.json",
                                      "--device", "cpu", "--mesh"))
    assert alone == want and not torch.distributed.is_initialized()
    launch("mesh", 2, workdir)
    assert json.loads((workdir / "mesh.json").read_text()) == want


def _train_writes_config(package, cfg, workdir):
    """config.json as each package's MaskYOLO.train writes it (zero epochs)."""
    if package == "jax":
        from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO

        model = JaxMaskYOLO("training", cfg, model_dir=str(workdir))
        model.train(_tiny_shapes(2, 64), _tiny_shapes(2, 64), 1e-3, epochs=0, verbose=False)
    else:
        model = MaskYOLO("training", cfg, model_dir=str(workdir), device="cpu")
        model.train(_tiny_shapes(2, 64), _tiny_shapes(2, 64), 1e-3, epochs=0, verbose=False)
    return workdir / "config.json"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_json_builds_equal_configs_in_both_packages(tmp_path, writer):
    """The config.json of either package's train builds the same config in
    both tools' build_config: every knob of the file equal, the same
    static_key (the shape- and compile-relevant values)."""
    import argparse

    from conftest import TinyConfig

    over = {"OBJ_THRESHOLD": 0.2, "MASK_TOP_K": 3, "QUANT_PER_CHANNEL_ACT": True}
    cfg = (type("J", (TinyConfig,), over)() if writer == "jax" else tiny(**over))
    path = _train_writes_config(writer, cfg, tmp_path)
    args = argparse.Namespace(config=None, config_json=str(path), labels=None)
    port = predict.build_config(args)
    jax_cfg = load_jax_tool("predict").build_config(args)
    knobs = {k: v for k, v in json.loads(path.read_text()).items() if k.isupper()}
    assert knobs["OBJ_THRESHOLD"] == 0.2 and knobs["NUM_CLASSES"] == 3
    for k, v in knobs.items():
        assert getattr(port, k) == getattr(jax_cfg, k) == v, k
    assert port.static_key() == jax_cfg.static_key()


# ---------------------------------------------------------------------------
# gen_anchors, export_model, serve_model, bench
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["boxes", "shapes"])
def test_gen_anchors_file_is_bit_equal_to_jax(tmp_path, monkeypatch, source):
    """anchors_<k>.txt from a boxes dump and from --dataset shapes: the
    port's file equals the JAX tool's byte for byte."""
    if source == "boxes":
        rng = np.random.RandomState(4)
        xy = rng.uniform(0, 150, (60, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 70, (60, 2))], axis=1)
        np.savetxt(tmp_path / "boxes.txt", boxes, fmt="%.2f", delimiter=",")
        argv = ["--boxes", str(tmp_path / "boxes.txt"), "--k", "4", "--grid", "7"]
    else:
        argv = ["--dataset", "shapes", "--k", "3"]
    run_jax_tool(monkeypatch, "gen_anchors", [*argv, "--out", str(tmp_path / "jax.txt")])
    gen_anchors.main([*argv, "--out", str(tmp_path / "port.txt")])
    want = (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "port.txt").read_bytes() == want and len(want.split(b",")) > 4


@pytest.fixture(scope="module")
def tool_weights(tmp_path_factory):
    """A seeded TinyConfig checkpoint of the port, its config.json (as the
    tools read it) and 8 uint8 images."""
    workdir = tmp_path_factory.mktemp("tools")
    model = MaskYOLO("inference", tiny(), seed=1, device="cpu")
    model.save_weights(str(workdir / "weights.pt"))
    (workdir / "config.json").write_text(json.dumps(TINY))
    images = (np.random.RandomState(2).rand(8, 64, 64, 3) * 255).astype(np.uint8)
    return workdir, images


def export_argv(workdir, out, *extra):
    return ["--weights", str(workdir / "weights.pt"), "--config-json",
            str(workdir / "config.json"), "--out", str(out), "--device", "cpu", *extra]


def test_export_model_verify_passes(tool_weights, tmp_path):
    """export_model --verify: the artifact reloads and equals the live model
    (exactly, on the CPU)."""
    workdir, _ = tool_weights
    header = export_model.main(export_argv(workdir, tmp_path / "m.pt2", "--verify"))
    assert header["platforms"] == ["cpu"] and header["batch_size"] is None


def test_export_model_verify_refuses_an_altered_artifact(tool_weights, tmp_path):
    """verify against a model whose weights moved (the artifact no longer
    matches it) exits with SystemExit, not an assertion; --platforms tpu is
    refused."""
    workdir, _ = tool_weights
    export_model.main(export_argv(workdir, tmp_path / "m.pt2"))
    other = MaskYOLO("inference", tiny(), seed=2, device="cpu")
    with pytest.raises(SystemExit, match="verify FAILED"):
        export_model.verify(tmp_path / "m.pt2", other, tiny())
    with pytest.raises(ValueError, match="platforms"):
        export_model.main(export_argv(workdir, tmp_path / "tpu.pt2", "--platforms", "tpu"))


def _post(port, image):
    buf = io.BytesIO()
    np.save(buf, image)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/detect", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("source", ["weights", "artifact"])
def test_serve_model_answers_http_like_detect_batch(tool_weights, tmp_path, source):
    """serve_model on port 0, from the checkpoint and from its artifact:
    4 POST /detect requests answered with detect_batch's detections."""
    workdir, images = tool_weights
    if source == "weights":
        argv = ["--weights", str(workdir / "weights.pt")]
    else:
        export_model.main(export_argv(workdir, tmp_path / "m.pt2"))
        argv = ["--artifact", str(tmp_path / "m.pt2")]
    args = serve_model.parser().parse_args(
        [*argv, "--port", "0", "--score-threshold", "0", "--batch-size", "2",
         "--device", "cpu"])
    server, ex = serve_model.start(None if args.artifact else tiny(), args)
    try:
        got = [_post(server.port, im) for im in images[:4]]
    finally:
        server.stop()
        ex.shutdown()
    model = MaskYOLO("inference", tiny(), device="cpu")
    model.load_weights(str(workdir / "weights.pt"))
    want = {k: v.numpy() for k, v in model.detect_batch(images[:4]).items()}
    assert ex.stats["requests"] == 5   # the 4 and the warm-up
    for i, res in enumerate(got):
        idx = np.where(want["valid"][i])[0]
        assert [d["class_id"] for d in res["detections"]] == want["classes"][i][idx].tolist()
        np.testing.assert_allclose([d["score"] for d in res["detections"]],
                                   want["scores"][i][idx], rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(np.reshape([d["box"] for d in res["detections"]], (-1, 4)),
                                   want["boxes"][i][idx], rtol=0, atol=BOX_TOL_PX)
    assert sum(len(r["detections"]) for r in got) > 0


def test_serve_model_refusals():
    """The JAX tool's refusals: --quantize or --config with --artifact, and
    neither or both of --weights / --artifact."""
    for argv in (["--artifact", "m.pt2", "--quantize"], ["--artifact", "m.pt2", "--config",
                                                          "shapes"],
                 [], ["--weights", "w", "--artifact", "m.pt2"]):
        with pytest.raises(SystemExit) as err:
            serve_model.main(argv)
        assert err.value.code == 2


def test_bench_prints_one_json_line(capsys):
    """bench.run on the CPU at TinyConfig, batch 2: one JSON line on stdout
    with the JAX bench's keys (bar vs_baseline) and the three paths."""
    import argparse

    cfg = tiny(COMPUTE_DTYPE="bfloat16")
    result = bench.run(cfg, argparse.Namespace(device="cpu", backbone=None), batch_size=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    assert {"metric", "value", "unit", "batch_size", "path", "per_path", "device",
            "timing"} <= result.keys()
    assert set(result["per_path"]) == {"bf16", "int8", "int8_fused"}
    assert all(v > 0 for v in result["per_path"].values())
    assert result["device"] == "cpu" and result["batch_size"] == 2
    assert result["value"] == max(result["per_path"].values())


# ---------------------------------------------------------------------------
# the quality tools
# ---------------------------------------------------------------------------


def jax_result_keys(name):
    """The keys tools/<name>.py of the JAX package sets on its metrics:
    `result["..."] = ...` assignments (and `result.pop`s, removed)."""
    keys, popped = set(), set()
    for node in ast.walk(ast.parse((ROOT / "tools" / f"{name}.py").read_text())):
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "result" and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "pop" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "result"):
            popped.add(node.args[0].value)
    return keys, popped


def evaluate_keys():
    from mask_yolo_tpu_torch import evaluate_dataset

    model = MaskYOLO("inference", tiny(), device="cpu")
    return set(evaluate_dataset(model, _tiny_shapes(2, 64), tiny(), batch_size=2))


def test_quality_run_writes_the_jax_metrics(tmp_path):
    """quality_run at one step of TinyConfig (Shapes labels), the AP
    callback every epoch and one overlay: metrics.json holds the JAX tool's
    keys, each AP in [0, 1]."""
    args = quality_run.parser().parse_args(
        ["--train-images", "2", "--val-images", "2", "--eval-images", "2", "--epochs", "1",
         "--batch-size", "2", "--eval-every", "1", "--num-overlays", "1", "--device", "cpu",
         "--out", str(tmp_path)])
    result = quality_run.run(quality_run.run_config(args, type("S", (Config,), SHAPES_TINY)),
                             args)
    assert json.loads((tmp_path / "metrics.json").read_text()) == result
    keys, popped = jax_result_keys("quality_run")
    assert set(result) == (keys | evaluate_keys()) - popped
    for k in ("box_ap50", "mask_ap50", "box_map", "mask_map", "int8_box_ap50",
              "int8_mask_ap50", "mean_recall50", "best_epoch_box_ap50"):
        assert 0.0 <= result[k] <= 1.0, k
    assert (tmp_path / "weights").exists() and list(tmp_path.glob("InferMaskYOLO-*.png"))


@pytest.fixture(scope="module")
def coco_run(tmp_path_factory):
    """quality_run_coco at one step of a 64², 3-class CocoStyleConfig."""
    out = tmp_path_factory.mktemp("coco")
    args = quality_run_coco.parser().parse_args(
        ["--train-images", "2", "--val-images", "2", "--eval-images", "3", "--epochs", "1",
         "--batch-size", "2", "--num-classes", "3", "--num-overlays", "0",
         "--int8-per-channel", "--int8-qat-steps", "1", "--calib-images", "2",
         "--device", "cpu", "--out", str(out)])
    base = type("C", (CocoStyleConfig,), {k: v for k, v in TINY.items()
                                          if k not in ("NAME", "LABELS", "NUM_CLASSES")})
    return out, quality_run_coco.run(quality_run_coco.run_config(args, base), args), base


def test_quality_run_coco_writes_the_jax_metrics(coco_run):
    """The COCO-format copy is written and read back; metrics.json holds
    the JAX tool's keys, each AP in [0, 1]."""
    out, result, _ = coco_run
    assert json.loads((out / "metrics.json").read_text()) == result
    keys, popped = jax_result_keys("quality_run_coco")
    assert set(result) == (keys | evaluate_keys()) - popped - {
        "best_epoch_box_ap50", "ap_trajectory"}   # set only with --eval-every
    for k in ("box_ap50", "mask_ap50", "int8_box_ap50", "int8_mask_ap50"):
        assert 0.0 <= result[k] <= 1.0, k
    assert result["num_classes"] == 3 and len(list((out / "coco_eval" / "images").iterdir())) == 3


def test_eval_int8_variants_on_the_coco_run(coco_run, tmp_path):
    """eval_int8 on the run's weights and eval split: f32 and three int8
    variants (per tensor, per channel, per channel + QAT) and a
    MASK_TOP_K sweep, each AP in [0, 1]."""
    out, _, base = coco_run
    args = eval_int8.parser().parse_args(
        ["--weights", str(out / "weights"), "--data", str(out / "coco_eval"),
         "--variants", "f32", "pt", "pc", "pc_qat_mw", "--num-classes", "3",
         "--calib-images", "2", "--qat-steps", "1", "--mask-top-k", "1", "--device", "cpu",
         "--out", str(tmp_path / "int8.json")])
    meta = eval_int8.run(eval_int8.run_config(args, base), args)
    assert json.loads((tmp_path / "int8.json").read_text()) == meta
    assert set(meta["results"]) == {"f32", "pt", "pc", "pc_qat_mw", "f32_topk1"}
    assert meta["n_images"] == 3
    for r in meta["results"].values():
        assert 0.0 <= r["box_ap50"] <= 1.0 and 0.0 <= r["mask_ap50"] <= 1.0


def test_materialize_textured_writes_reusable_splits(tmp_path, capsys):
    """The three textured splits at 64²; a second run reuses them (same
    sidecar, same annotations file)."""
    argv = ["--out", str(tmp_path), "--train-images", "2", "--val-images", "1",
            "--eval-images", "1", "--num-classes", "3"]
    args = materialize_textured.parser().parse_args(argv)
    splits = materialize_textured.run(tiny(), args)
    assert {k: len(d.image_ids) for k, d in splits.items()} == {
        "coco_val": 1, "coco_eval": 1, "coco_train": 2}
    meta = json.loads((tmp_path / "coco_train" / "materialize_meta.json").read_text())
    assert meta == {"count": 2, "seed": 0, "num_classes": 3, "textured": True, "size": 64}
    before = (tmp_path / "coco_train" / "instances.json").stat().st_mtime_ns
    materialize_textured.run(tiny(), args)
    assert (tmp_path / "coco_train" / "instances.json").stat().st_mtime_ns == before


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool,argv", [
    ("bench", []),
    ("predict", ["--weights", "w.pt", "--config", "shapes", "--images", "{png}"]),
    ("export_model", ["--weights", "w.pt", "--config", "shapes", "--out", "m.pt2"]),
    ("serve_model", ["--weights", "w.pt"]),
    ("quality_run", ["--train-images", "1", "--val-images", "1", "--eval-images", "1"]),
    ("eval_int8", ["--weights", "w.pt", "--data", "{coco}"]),
    ("bench_roofline", ["--size", "8", "--bandwidth-mb", "1"]),
    ("profile_stages", ["2"]),
    ("profile_stages_416", ["--batch", "2"]),
    ("profile_infer_yolo", ["--batch", "2"]),
    ("profile_layers_416", ["--batch", "2"]),
    ("bench_416", ["--batch", "2"]),
    ("bench_export", ["--batch", "2"]),
    ("bench_train", ["--batch", "2", "--images", "2"]),
    ("ab_infer_yolo_exactness", ["--weights", "w.pt", "--data", "{coco}"]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_tools_run_on_the_card_unless_asked(tmp_path, monkeypatch, tool, argv):
    """Without --device each tool asks for the card: with no CUDA device it
    raises before doing any work, and never falls back to the CPU."""
    from mask_yolo_tpu_torch.data.coco import dataset_to_coco_json

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    write_images(tmp_path / "png", 1, 64, seed=0)
    dataset_to_coco_json(_tiny_shapes(1, 64), str(tmp_path / "coco"))
    argv = [a.format(png=tmp_path / "png" / "0.png", coco=tmp_path / "coco") for a in argv]
    module = bench if tool == "bench" else getattr(sys.modules[__name__], tool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


if __name__ == "__main__":
    case, workdir = sys.argv[1], sys.argv[2]
    {"mesh": worker_mesh}[case](workdir)
