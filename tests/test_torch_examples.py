"""The port's example scripts (mask_yolo_tpu_torch/examples) on the CPU at
TinyConfig size, each with `--device cpu`: every `run()` at one training
step or a few images, on Shapes scenes generated from a seed and on a tiny
VIA set and COCO set written here. The scripts are thin: what each test
holds is that the script reaches the library with the flags the JAX
script had and returns what it computed (a checkpoint, detections drawn to
PNG files, metrics)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mask_yolo_tpu_torch.config import CocoStyleConfig, Config
from mask_yolo_tpu_torch.data.coco import dataset_to_coco_json
from mask_yolo_tpu_torch.data.shapes import ShapesDataset
from mask_yolo_tpu_torch.examples.coco import train_coco
from mask_yolo_tpu_torch.examples.food import test_food_generator, train_food
from mask_yolo_tpu_torch.examples.rice import test_rice_generator, train_rice
from mask_yolo_tpu_torch.examples.shapes import (eval_shapes, infer_shapes, infer_shapes_yolo,
                                                 test_data_generator, train_shapes)
from test_torch_tools import SHAPES_TINY, TINY

torch.set_num_threads(2)


def shapes_tiny(**over):
    return type("ShapesTiny", (Config,), {**SHAPES_TINY, **over})()


def via_tiny():
    return type("ViaTiny", (Config,), {**TINY, "NUM_CLASSES": 2,
                                       "LABELS": ["background", "object"]})()


@pytest.fixture(scope="module")
def shapes_checkpoint(tmp_path_factory):
    """train_shapes for one step (2 images, batch 2): the checkpoint of
    its one epoch."""
    workdir = tmp_path_factory.mktemp("shapes")
    args = train_shapes.parser().parse_args(
        ["--train-images", "2", "--val-images", "2", "--epochs", "1",
         "--model-dir", str(workdir), "--device", "cpu"])
    model = train_shapes.run(shapes_tiny(), args)
    assert model.epoch == 1
    (ckpt,) = workdir.glob("saved_model_*_e0001.pt")
    assert json.loads((workdir / "config.json").read_text())["NUM_CLASSES"] == 4
    return ckpt


def test_train_shapes_yolo_mode_with_augmentation(tmp_path):
    """--mode yolo --augment: one step of the YOLO loss from the augmenting
    generator, a checkpoint written."""
    args = train_shapes.parser().parse_args(
        ["--train-images", "2", "--val-images", "2", "--epochs", "1", "--mode", "yolo",
         "--augment", "--lr", "1e-4", "--model-dir", str(tmp_path), "--device", "cpu"])
    model = train_shapes.run(shapes_tiny(), args)
    assert model.mode == "yolo" and len(list(tmp_path.glob("saved_model_*.pt"))) == 1


def test_infer_shapes_draws_each_image(shapes_checkpoint, tmp_path):
    args = infer_shapes.parser().parse_args(
        ["--weights", str(shapes_checkpoint), "--num-images", "2", "--save-path",
         str(tmp_path), "--device", "cpu"])
    results = infer_shapes.run(shapes_tiny(BATCH_SIZE=1), args)
    assert len(results) == 2
    assert all(r["full_masks"].shape[:2] == (64, 64) for r in results)
    assert list(tmp_path.glob("InferMaskYOLO-*.png"))


def test_infer_shapes_yolo_draws_each_image(shapes_checkpoint, tmp_path):
    args = infer_shapes_yolo.parser().parse_args(
        ["--weights", str(shapes_checkpoint), "--num-images", "2", "--save-path",
         str(tmp_path), "--device", "cpu"])
    boxes = infer_shapes_yolo.run(shapes_tiny(BATCH_SIZE=1, OBJ_THRESHOLD=0.0), args)
    assert len(boxes) == 2 and sum(len(b) for b in boxes) > 0
    assert list(tmp_path.glob("InferYOLO-*.png"))


def test_eval_shapes_metrics(shapes_checkpoint):
    args = eval_shapes.parser().parse_args(
        ["--weights", str(shapes_checkpoint), "--num-images", "3", "--batch-size", "2",
         "--device", "cpu"])
    result = eval_shapes.run(shapes_tiny(), args)
    assert 0.0 <= result["box_ap50"] <= 1.0 and 0.0 <= result["mask_ap50"] <= 1.0
    assert "per_image" not in result


def test_data_generator_picture(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    batch = test_data_generator.run(shapes_tiny(BATCH_SIZE=4))
    assert batch["image"].shape == (4, 64, 64, 3)
    assert (tmp_path / "generator_sanity.png").exists()


@pytest.fixture(scope="module")
def via_root(tmp_path_factory):
    """A tiny VIA dataset: train/ and val/ with two 64² images each, each
    with two polygon regions (2.x list format)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("via")
    rng = np.random.RandomState(1)
    for subset in ("train", "val"):
        d = root / subset
        d.mkdir()
        ann = {}
        for i in range(2):
            name = f"img{i}.png"
            Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(d / name)
            regions = [
                {"shape_attributes": {"name": "polygon", "all_points_x": [8, 30, 18],
                                      "all_points_y": [8, 10, 28]}},
                {"shape_attributes": {"name": "polygon", "all_points_x": [36, 60, 60, 36],
                                      "all_points_y": [30, 30, 58, 58]}}]
            ann[name] = {"filename": name, "regions": regions}
        (d / "via_region_data.json").write_text(json.dumps(ann))
    return root


@pytest.mark.parametrize("script", [train_rice, train_food], ids=["rice", "food"])
def test_via_train_then_infer(via_root, tmp_path, monkeypatch, script):
    """--command train for one step on train/ (val/ for validation), then
    --command infer on val/ with that checkpoint (overlays into
    ./img_results/)."""
    monkeypatch.chdir(tmp_path)
    args = script.parser().parse_args(["--dataset", str(via_root), "--epochs", "1",
                                       "--model-dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    model = script.run(via_tiny(), args)
    assert model.epoch == 1
    (ckpt,) = (tmp_path / "ckpt").glob("saved_model_*.pt")
    args = script.parser().parse_args(["--dataset", str(via_root), "--command", "infer",
                                       "--weights", str(ckpt), "--device", "cpu"])
    results = script.run(via_tiny(), args)
    assert len(results) == 2 and list((tmp_path / "img_results").glob("*.png"))


@pytest.mark.parametrize("script", [test_rice_generator, test_food_generator],
                         ids=["rice", "food"])
def test_via_generator_picture(via_root, tmp_path, script):
    args = script.parser().parse_args(["--dataset", str(via_root),
                                       "--save-path", str(tmp_path / "check.png")])
    batch = script.run(via_tiny(), args)
    assert (batch["gt_class_ids"][0] > 0).sum() == 2 and (tmp_path / "check.png").exists()


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """Seeded 64² Shapes scenes written as COCO datasets (train, val)."""
    root = tmp_path_factory.mktemp("coco")
    for subset, seed in (("train", 0), ("val", 1)):
        ds = ShapesDataset()
        ds.load_shapes(2, 64, 64, seed=seed)
        ds.prepare()
        dataset_to_coco_json(ds, str(root / subset))
    return root


def coco_argv(root, *extra):
    return ["--val-ann", str(root / "val" / "instances.json"),
            "--val-images", str(root / "val" / "images"), "--batch-size", "2",
            "--device", "cpu", *extra]


def test_train_coco_train_eval_infer(coco_root, tmp_path, monkeypatch):
    """train (one step), eval (metrics in [0, 1]) and infer (overlays) on
    the COCO-format sets, the config's classes taken from the val set."""
    monkeypatch.chdir(tmp_path)
    base = type("C", (CocoStyleConfig,), {k: v for k, v in TINY.items()
                                          if k not in ("NAME", "LABELS", "NUM_CLASSES")})

    def run(*extra):
        args = train_coco.parser().parse_args(coco_argv(coco_root, *extra))
        val = train_coco.load(args.val_ann, args.val_images)
        return train_coco.run(train_coco.run_config(args, val, base), args)

    model = run("--train-ann", str(coco_root / "train" / "instances.json"),
                "--train-images", str(coco_root / "train" / "images"), "--epochs", "1",
                "--model-dir", str(tmp_path / "ckpt"))
    assert model.config.NUM_CLASSES == 4 and model.epoch == 1
    (ckpt,) = (tmp_path / "ckpt").glob("saved_model_*.pt")
    result = run("--command", "eval", "--weights", str(ckpt))
    assert 0.0 <= result["box_ap50"] <= 1.0
    results = run("--command", "infer", "--weights", str(ckpt), "--score-threshold", "0")
    assert len(results) == 2 and list(Path("img_results").glob("*.png"))
    with pytest.raises(SystemExit, match="--train-ann"):
        run()
