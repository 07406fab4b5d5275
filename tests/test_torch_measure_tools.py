"""The port's measurement tools other than the stage profilers
(mask_yolo_tpu_torch/tools/bench_roofline.py, profile_layers_416.py,
bench_416.py, bench_train.py, r5_studies.sh; bench_export.py and
ab_infer_yolo_exactness.py in tests/test_torch_measure_export.py) on the
CPU at TinyConfig size, each through main([... "--device", "cpu"]) or
run(config, args).

Every row carries the JAX tool's keys (read from its json.dumps calls, or
listed with the JAX line cited); timings are only checked to be finite and
> 0. Every field that is not a timing is held against what the JAX package
computes on the same weights and data: the layer walk of
profile_layers_416 (layer, input shape, dtype and scales) against the one
derived from the JAX graph, the GEMM shapes and GFLOP/img; bench_train's
`mb_per_step` against the bytes of the JAX generator's first batch;
bench_export's `compute_path` against the JAX export header's; and
ab_infer_yolo_exactness's whole JSON against the JAX tool's, run (with
--cpu) from its file on the same checkpoint and COCO directory. A path or
probe that raises makes a tool print its error line and exit 1.
"""

import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from conftest import TinyConfig  # noqa: E402
from mask_yolo_tpu import quant as jquant  # noqa: E402
from mask_yolo_tpu_torch import MaskYOLO, weights  # noqa: E402
from mask_yolo_tpu_torch.config import CocoStyleConfig  # noqa: E402
from mask_yolo_tpu_torch.data.shapes import ShapesConfig  # noqa: E402
from mask_yolo_tpu_torch.tools import (bench_416, bench_roofline, bench_train,  # noqa: E402
                                       profile_layers_416)
from test_torch_measure_stages import (JaxInt8, assert_rows_carry_jax_keys,  # noqa: E402
                                       jax_json_keys, port_int8_config)
from test_torch_quant import spread_variables  # noqa: E402

torch.set_num_threads(2)

# TinyConfig's widths on the tools' own configs
WIDTHS = {k: v for k, v in vars(TinyConfig).items()
          if k.isupper() and k not in ("NAME", "LABELS", "NUM_CLASSES")}
TinyCoco = type("TinyCoco", (CocoStyleConfig,), WIDTHS)
TinyShapes = type("TinyShapes", (ShapesConfig,), WIDTHS)


def printed_rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


# ---------------------------------------------------------------------------
# bench_roofline
# ---------------------------------------------------------------------------


def test_bench_roofline_prints_the_jax_rows(capsys):
    rows = bench_roofline.main(["--size", "64", "--bandwidth-mb", "1", "--device", "cpu"])
    assert printed_rows(capsys) == rows
    assert_rows_carry_jax_keys(rows, jax_json_keys("bench_roofline"))
    assert [r.get("dtype", r.get("probe")) for r in rows] == [
        "hbm_copy", "bfloat16", "float32", "int8"]
    assert rows[2]["tf32"] is False and "tf32" not in rows[1]
    assert all(np.isfinite(r.get("tops", r.get("gbps"))) and r.get("tops", r.get("gbps")) > 0
               for r in rows)


@pytest.mark.parametrize("tool", ["bench_roofline", "bench_416"])
def test_a_failing_path_prints_its_error_line_and_exits_1(tool, capsys, monkeypatch):
    """The JAX tools' {"path"/"dtype": ..., "error": ...} line, the other
    rows still printed, and exit code 1 at the end."""
    if tool == "bench_roofline":
        argv = ["--size", "32", "--bandwidth-mb", "0", "--dtypes", "bfloat16,float64"]
        module, failing = bench_roofline, {"dtype": "float64"}
    else:   # K3 takes one map: the hybrid FPN detector refuses it
        monkeypatch.setattr(bench_416, "run_config",
                            lambda args, base=None: type("F", (TinyCoco,), {
                                "BACKBONE": "resnet50_fpn"})())
        argv = ["--batch", "2", "--paths", "int8,pallas_mask"]
        module, failing = bench_416, {"path": "pallas_mask"}
    with pytest.raises(SystemExit) as err:
        module.main([*argv, "--device", "cpu"])
    assert err.value.code == 1
    rows = printed_rows(capsys)
    bad = [r for r in rows if "error" in r]
    assert len(rows) == 2 and len(bad) == 1
    assert failing.items() <= bad[0].items() and set(bad[0]) == set(failing) | {"error"}


# ---------------------------------------------------------------------------
# profile_layers_416
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_graphs():
    _, vf, _ = spread_variables()
    calib = np.random.RandomState(3).rand(4, *JaxInt8.IMAGE_SHAPE).astype(np.float32)
    jdet = jquant.QuantizedDetector.from_variables(vf, JaxInt8(), calib)
    return jdet.graph, weights.from_jax_graph(jdet.graph)


def jax_walk(graph, cfg):
    """tools/profile_layers_416.py:238-260 (the walk) on the JAX graph."""
    h, w = cfg.IMAGE_SHAPE[:2]

    def walk(layers, hw, cin):
        scale = None
        rows = []
        for i, layer in enumerate(layers):
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            out_scale = (nxt.a_scale if nxt is not None
                         and jquant._scale_ok(nxt.a_scale) else None)
            kh, kw, _, ko = np.asarray(layer.kernel).shape
            ho = math.ceil(hw[0] / layer.strides[0])
            wo = math.ceil(hw[1] / layer.strides[1])
            rows.append(dict(layer=layer, in_hw=hw, cin=cin, out_hw=(ho, wo), cout=ko,
                             kh=kh, kw=kw, in_scale=scale, out_scale=out_scale))
            hw, cin, scale = (ho, wo), ko, out_scale
        assert scale is None
        return rows, hw, cin

    rows, c4_hw, c4_c = walk(graph["trunk"], (h, w), 3)
    return rows + walk(graph["neck"], c4_hw, c4_c)[0] + walk(graph["yolo"], c4_hw, c4_c)[0]


def jax_flops(r, b):
    """tools/profile_layers_416.py:272-279."""
    layer = r["layer"]
    m = b * r["out_hw"][0] * r["out_hw"][1]
    if layer.groups == 1:
        kdim, n_dim = r["kh"] * r["kw"] * r["cin"], r["cout"]
    else:
        kdim, n_dim = r["kh"] * r["kw"], 1
    return m, kdim, n_dim, 2.0 * m * kdim * n_dim * (r["cout"] if layer.groups > 1 else 1)


def test_profile_layers_walk_matches_jax(int8_graphs):
    """Each layer's name, input shape, input dtype (int8 iff it has an input
    scale), input and output scale, and the contraction (M, K, N, FLOPs)."""
    jgraph, pgraph = int8_graphs
    want = jax_walk(jgraph, JaxInt8())
    got = profile_layers_416.walk_graph(pgraph, port_int8_config())
    assert len(got) == len(want) > 20
    n_int8_in = 0
    for g, w in zip(got, want):
        assert g["layer"].name == w["layer"].name
        assert (g["in_hw"], g["cin"], g["out_hw"], g["cout"]) == (
            tuple(w["in_hw"]), w["cin"], w["out_hw"], w["cout"]), g["layer"].name
        for key in ("in_scale", "out_scale"):
            assert (g[key] is None) == (w[key] is None), (g["layer"].name, key)
            if w[key] is not None:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
        n_int8_in += g["in_scale"] is not None
        assert profile_layers_416.contraction(g, 3) == jax_flops(w, 3)
    assert n_int8_in > 10


def test_profile_layers_prints_the_jax_rows(capsys, monkeypatch):
    """main() on a TinyConfig-sized CocoStyleConfig: a row a layer with the
    JAX keys, the GEMM shape padded as ops.int8.int_mm pads it, gflop_per_img
    from the contraction, the WHOLE_TRUNK row; and --prefix's rows."""
    monkeypatch.setattr(profile_layers_416, "bench_config", TinyCoco)
    rows = profile_layers_416.main(["--batch", "2", "--device", "cpu"])
    assert printed_rows(capsys) == rows
    sets = jax_json_keys("profile_layers_416")   # WHOLE_TRUNK's (:313), --prefix's (:195)
    # a layer's row is built up with out[...] = ... (:277-305), so listed here
    layer_keys = {"layer", "kind", "in", "out", "stride", "int8", "gflop_per_img",
                  "us_per_img", "eff_tops", "gbps"}
    gemm_keys = {"gemm_us_per_img", "gemm_tops", "pct_of_gemm"}
    assert_rows_carry_jax_keys(rows, [s for s in sets if "prefix" not in s] + [layer_keys])
    cfg = TinyCoco()
    layers = rows[:-1]
    assert rows[-1]["layer"] == "WHOLE_TRUNK" and rows[-1]["sum_isolated_us_per_img"] > 0
    walked = profile_layers_416.walk_graph(
        profile_layers_416._timing.quantized(MaskYOLO("inference", cfg, seed=0, device="cpu"),
                                             cfg, torch.device("cpu")).graph, cfg)
    assert [r["layer"] for r in layers] == [w["layer"].name for w in walked]
    for r, w in zip(layers, walked):
        m, k, n, ops = profile_layers_416.contraction(w, 2)
        assert r["gflop_per_img"] == pytest.approx(ops / 2 / 1e9)
        assert r["in"] == [*w["in_hw"], w["cin"]] and r["out"] == [*w["out_hw"], w["cout"]]
        if r["int8"] and w["layer"].groups == 1:
            assert gemm_keys <= set(r)
            assert r["gemm_shape"] == [m, -(-k // 8) * 8, -(-n // 8) * 8]
        else:
            assert not gemm_keys & set(r)
    stem = layers[0]
    assert stem["layer"] == "conv1" and stem["gemm_shape"][1] == 32   # K = 27 padded

    rows = profile_layers_416.main(["--batch", "2", "--prefix", "--device", "cpu"])
    assert_rows_carry_jax_keys(rows, [s for s in sets if "prefix" in s])
    assert [r["prefix"].split(":")[1] for r in rows] == [w["layer"].name for w in walked]


# ---------------------------------------------------------------------------
# bench_416
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--set", "QUANT_PER_CHANNEL_ACT=True"]],
                         ids=["per_tensor", "per_channel"])
def test_bench_416_prints_the_jax_rows(extra, capsys, monkeypatch):
    """Every path (per channel: the two the knob changes, K1's and K3's),
    the JAX keys, the overrides of --set in each row; --k-block is accepted
    and ignored."""
    monkeypatch.setattr(bench_416, "run_config",
                        lambda args, base=None, f=bench_416.run_config: f(args, TinyCoco))
    paths = ["fused_ds", "pallas_mask"] if extra else list(bench_416.PATHS)
    rows = bench_416.main(["--batch", "2", "--paths", ",".join(paths),
                           "--k-block", "8", *extra, "--device", "cpu"])
    assert printed_rows(capsys) == rows
    assert_rows_carry_jax_keys(rows, jax_json_keys("bench_416"))
    assert [r["path"] for r in rows] == paths
    for r in rows:
        assert r["backbone"] == "mobilenet" and r["batch"] == 2
        assert r.get("QUANT_PER_CHANNEL_ACT", None) == (True if extra else None)


# ---------------------------------------------------------------------------
# bench_train
# ---------------------------------------------------------------------------

# tools/bench_train.py:238-254 builds its row with out[...] and out.update
TRAIN_KEYS = {"batch_size", "config", "device", "device_only_images_per_sec",
              "e2e_images_per_sec", "e2e_sec_per_step", "mb_per_step", "payload",
              "augmented_generator"}
SPLIT_KEYS = {"fwd_only_images_per_sec", "fwd_us_per_img", "step_us_per_img",
              "bwd_opt_over_fwd"}


def jax_first_batch_bytes(cfg, n_images, legacy, augment):
    """tools/bench_train.py:151-170: the bytes of the JAX generator's first
    batch."""
    from mask_yolo_tpu.data.pipeline import (BatchGenerator, GeneratorEpochSource,
                                             data_generator, preload_dataset)
    from mask_yolo_tpu.data.shapes import ShapesDataset

    if legacy:
        cfg = type("L", (type(cfg),), {"USE_MINI_MASK": False})()
    ds = ShapesDataset()
    ds.load_shapes(n_images, *cfg.IMAGE_SHAPE[:2], seed=0)
    ds.prepare()
    if augment:
        from mask_yolo_tpu.data.augment import default_augmenter

        gen = GeneratorEpochSource(data_generator(ds, cfg, shuffle=True,
                                                  augmentation=default_augmenter(seed=0),
                                                  seed=0), n_images // cfg.BATCH_SIZE, cfg)
    else:
        data = preload_dataset(ds, cfg)
        if legacy:
            data = dict(data, images=data["images"].astype(np.float32) / 255.0)
        gen = BatchGenerator(data, cfg, mode="training", shuffle=False)
    return sum(np.asarray(v).nbytes for v in gen[0].values())


@pytest.mark.parametrize("mode", ["uint8_minimask", "legacy", "augment"])
def test_bench_train_prints_the_jax_row(mode, capsys):
    """Batch 2, 4 images of TinyConfig-sized Shapes (bf16): the JAX keys,
    mb_per_step equal to the JAX generator's first batch, the payload, the
    TF32 state; --split on the first case."""
    extra = {"uint8_minimask": ["--split"], "legacy": ["--legacy"],
             "augment": ["--augment", "--skip-device"]}[mode]
    argv = ["--batch", "2", "--images", "4", *extra, "--device", "cpu"]
    args = bench_train.parser().parse_args(argv)
    cfg = bench_train.run_config(args, TinyShapes)
    rows = bench_train.run(cfg, args)
    assert printed_rows(capsys) == rows and len(rows) == 1
    row = rows[0]
    want = TRAIN_KEYS - ({"device_only_images_per_sec"} if mode == "augment" else set())
    assert want <= set(row)
    if mode == "uint8_minimask":
        assert SPLIT_KEYS <= set(row) and row["bwd_opt_over_fwd"] > -1
    for k in ("device_only_images_per_sec", "e2e_images_per_sec", "e2e_sec_per_step"):
        if k in row:
            assert np.isfinite(row[k]) and row[k] > 0
    assert row["payload"] == ("legacy_f32_fullmask" if mode == "legacy" else "uint8_minimask")
    assert row["augmented_generator"] == (mode == "augment")
    assert row["compute_dtype"] == "bfloat16" and row["tf32"]["matmul"] is False
    jcfg = type("J", (TinyConfig,), {"NUM_CLASSES": 4, "BATCH_SIZE": 2,
                                     "LABELS": list(ShapesConfig.LABELS),
                                     "COMPUTE_DTYPE": "bfloat16",
                                     **{k: getattr(ShapesConfig, k) for k in (
                                         "USE_MINI_MASK", "MASK_TRAIN_TOP_ROIS",
                                         "MINI_MASK_SHAPE", "TRAIN_BN")}})()
    assert row["mb_per_step"] * 1e6 == jax_first_batch_bytes(
        jcfg, 4, mode == "legacy", mode == "augment")


# ---------------------------------------------------------------------------
# r5_studies.sh
# ---------------------------------------------------------------------------


def test_r5_studies_runs_the_five_steps_through_the_port():
    """The JAX script's five steps, each a `python -m
    mask_yolo_tpu_torch.tools.<name>` that exists, with --device passed
    through; bash parses it."""
    import subprocess

    script = ROOT / "mask_yolo_tpu_torch" / "tools" / "r5_studies.sh"
    assert subprocess.run(["bash", "-n", str(script)], timeout=30).returncode == 0
    text = script.read_text()
    commands = re.findall(r"python -m (mask_yolo_tpu_torch\.tools\.\w+)((?:.*\\\n)*.*)", text)
    jax_steps = re.findall(r"python tools/(\w+)\.py", (ROOT / "tools" / "r5_studies.sh")
                           .read_text())
    assert [c[0].rsplit(".", 1)[1] for c in commands] == jax_steps
    for module, rest in commands:
        assert (ROOT / (module.replace(".", "/") + ".py")).exists(), module
        assert '--device "$DEVICE"' in rest, module
    assert "mask_yolo_tpu." not in text.replace("mask_yolo_tpu_torch", "")
