"""The port's evaluation (`utils/metrics.py`, `evaluate.py`) against the JAX
package's: the metrics on seeded boxes and masks (numpy copies: equal), and
`evaluate_dataset` on the same bridged weights at TinyConfig size, which
gives the JAX package's numbers (the detections agree to 1e-5 and the same
boxes clear every IoU threshold, so every AP is equal; checked to 1e-9).
Then the AP callback: `history`, `best`, the sidecar and the saved weights."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO
from mask_yolo_tpu import evaluate_dataset as jax_evaluate_dataset
from mask_yolo_tpu.data.shapes import ShapesDataset as JaxShapesDataset
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet
from mask_yolo_tpu.utils import metrics as jmetrics
from mask_yolo_tpu_torch import MaskYOLO
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.data.shapes import ShapesDataset
from mask_yolo_tpu_torch.evaluate import evaluate_dataset, make_ap_eval_callback
from mask_yolo_tpu_torch.utils import metrics
from test_torch_slice import _spread

torch.set_num_threads(2)


class ShapesTiny(TinyConfig):
    NUM_CLASSES = 4
    LABELS = ["background", "square", "circle", "triangle"]
    OBJ_THRESHOLD = 0.05          # random weights: let detections through


def port_config(jax_config, **over):
    values = {k: getattr(jax_config, k) for k in dir(jax_config) if k.isupper()}
    values.update(over)
    return type("Port" + type(jax_config).__name__, (Config,), values)()


def shapes(cls, count, seed):
    ds = cls()
    ds.load_shapes(count, 64, 64, seed=seed)
    ds.prepare()
    return ds


def _detections(rng, n_gt, n_pred):
    """Ground truth and jittered predictions with masks on a 48x48 canvas."""
    def boxes(n):
        xy = rng.randint(0, 28, (n, 2))
        return np.concatenate([xy, xy + rng.randint(6, 20, (n, 2))], -1).astype(np.float64)

    def masks(bxs):
        m = np.zeros((48, 48, len(bxs)), bool)
        for i, (x1, y1, x2, y2) in enumerate(bxs.astype(int)):
            m[y1:y2, x1:x2, i] = True
        return m

    gt = boxes(n_gt)
    pred = np.concatenate([gt[rng.randint(0, n_gt, n_pred // 2)] + rng.randint(-3, 4, (n_pred // 2, 4)),
                           boxes(n_pred - n_pred // 2)])
    pred[:, 2:] = np.maximum(pred[:, 2:], pred[:, :2] + 1)
    pred = np.clip(pred, 0, 47)
    return (gt, rng.randint(1, 4, n_gt), masks(gt), pred, rng.randint(1, 4, n_pred),
            np.round(rng.rand(n_pred), 1), masks(pred))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    rng = np.random.RandomState(seed)
    gt_b, gt_c, gt_m, p_b, p_c, p_s, p_m = _detections(rng, 5, 8)
    np.testing.assert_array_equal(metrics.compute_overlaps(p_b, gt_b),
                                  jmetrics.compute_overlaps(p_b, gt_b))
    np.testing.assert_array_equal(metrics.compute_overlaps_masks(p_m, gt_m),
                                  jmetrics.compute_overlaps_masks(p_m, gt_m))
    for use_masks in (False, True):
        args = (gt_b, gt_c, gt_m if use_masks else None, p_b, p_c, p_s,
                p_m if use_masks else None)
        for got, want in zip(metrics.compute_matches(*args), jmetrics.compute_matches(*args)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(metrics.compute_ap(*args), jmetrics.compute_ap(*args)):
            np.testing.assert_array_equal(got, want)
        assert metrics.compute_ap_range(*args) == jmetrics.compute_ap_range(*args)
    for got, want in zip(metrics.compute_recall(p_b, gt_b), jmetrics.compute_recall(p_b, gt_b)):
        np.testing.assert_array_equal(got, want)
    acc, jacc = metrics.APAccumulator(), jmetrics.APAccumulator()
    for _ in range(3):
        sample = _detections(rng, 4, 6)
        acc.add(*sample)
        jacc.add(*sample)
    for use_masks in (False, True):
        assert acc.ap(0.5, use_masks=use_masks) == jacc.ap(0.5, use_masks=use_masks)
        assert acc.map_range(use_masks=use_masks) == jacc.map_range(use_masks=use_masks)


@pytest.fixture(scope="module")
def bridged():
    """A JAX inference model and the port's on the same spread weights."""
    jcfg = ShapesTiny()
    net = JaxNet(num_classes=jcfg.NUM_CLASSES, n_box=jcfg.N_BOX,
                 top_feature_map_depth=jcfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=jcfg.MASK_POOL_SIZE)
    variables = _spread(net.init(jax.random.PRNGKey(2), jnp.zeros((1, *jcfg.IMAGE_SHAPE)),
                                 jnp.zeros((1, 4, 4)), train=False), np.random.RandomState(5))
    jmodel = JaxMaskYOLO("inference", jcfg)
    jmodel.params, jmodel.batch_stats = variables["params"], variables["batch_stats"]
    cfg = port_config(jcfg)
    model = MaskYOLO("inference", cfg, seed=0, device="cpu")
    model.load_jax_variables(variables)
    return jcfg, jmodel, cfg, model


@pytest.mark.parametrize("count, batch_size", [(4, 2), (5, 4)], ids=["even", "padded_tail"])
def test_evaluate_dataset_gives_the_jax_packages_numbers(bridged, count, batch_size):
    jcfg, jmodel, cfg, model = bridged
    want = jax_evaluate_dataset(jmodel, shapes(JaxShapesDataset, count, 11), jcfg,
                                batch_size=batch_size)
    got = evaluate_dataset(model, shapes(ShapesDataset, count, 11), cfg, batch_size=batch_size)
    assert got["n_images"] == want["n_images"] == count
    assert sum(row["n_pred"] for row in got["per_image"]) > 0
    for key, value in want.items():
        if key != "per_image":
            assert got[key] == pytest.approx(value, abs=1e-9), key
            assert 0.0 <= got[key] <= 1.0 or key == "n_images"
    for g, w in zip(got["per_image"], want["per_image"]):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key] == pytest.approx(w[key], abs=1e-9), key


def test_evaluate_dataset_takes_duck_typed_models_and_refuses_a_mesh(bridged):
    _, _, cfg, model = bridged
    ds = shapes(ShapesDataset, 2, 11)

    class Adapter:
        def detect_batch(self, images):
            return {k: v.numpy() for k, v in model.detect_batch(images).items()}

    assert (evaluate_dataset(Adapter(), ds, cfg, batch_size=2)["box_ap50"]
            == evaluate_dataset(model, ds, cfg, batch_size=2)["box_ap50"])
    with pytest.raises(NotImplementedError, match="#8"):
        evaluate_dataset(model, ds, cfg, mesh=True)


def test_ap_callback_history_best_sidecar_and_weights(tmp_path):
    """The callback inside a short train(): evaluates every 2nd epoch on the
    in-flight weights (cast to the inference model's compute dtype, here
    bf16 from f32 masters), appends to history and the history file, keeps
    the best value, its sidecar and the best weights, and a second callback
    resumes from the sidecar."""
    cfg = port_config(ShapesTiny(), COMPUTE_DTYPE="bfloat16", STEPS_PER_EPOCH=2,
                      VALIDATION_STEPS=1)
    train_ds, val_ds = shapes(ShapesDataset, 4, 2), shapes(ShapesDataset, 2, 3)
    history_path, best_path = str(tmp_path / "ap.jsonl"), str(tmp_path / "best.pt")
    cb = make_ap_eval_callback(val_ds, cfg, every=2, batch_size=2, score_threshold=0.0,
                               history_path=history_path, best_weights_path=best_path,
                               track="mean_recall50", verbose=False)
    seen = {}

    def spy(epoch, metrics_, val_loss, state):
        seen[epoch] = {k: p.detach().clone() for k, p in state.params.items()}

    model = MaskYOLO("training", cfg, model_dir=str(tmp_path / "ckpt"), seed=0, device="cpu")
    model.train(train_ds, val_ds, 1e-3, epochs=4, verbose=False, custom_callbacks=[spy, cb])
    assert [h["epoch"] for h in cb.history] == [2, 4]
    lines = [json.loads(line) for line in open(history_path)]
    assert lines == cb.history and "per_image" not in lines[0]
    for entry in cb.history:
        for key, value in entry.items():
            assert np.isfinite(value) and (key in ("epoch", "n_images") or 0.0 <= value <= 1.0)
    assert cb.best == max(h["mean_recall50"] for h in cb.history)
    sidecar = json.load(open(best_path + ".best.json"))
    assert sidecar["mean_recall50"] == cb.best and sidecar["epoch"] in (2, 4)
    # the saved weights are the in-flight masters of that epoch, in the
    # inference model's compute dtype
    saved = torch.load(best_path, weights_only=True)["params"]
    k = "mask.mask_conv1.weight"
    assert saved[k].dtype == torch.bfloat16
    assert torch.equal(saved[k], seen[sidecar["epoch"] - 1][k].bfloat16())
    # a later, weaker evaluation must not overwrite an earlier best: a new
    # callback starts from the sidecar's value
    again = make_ap_eval_callback(val_ds, cfg, every=1, best_weights_path=best_path,
                                  track="mean_recall50", verbose=False)
    assert again.best == cb.best
    with pytest.raises(ValueError, match="track"):
        make_ap_eval_callback(val_ds, cfg, track="val_loss")


def test_ap_callback_drops_the_int8_detector(bridged, tmp_path):
    """Weights handed to the inference model invalidate its int8 detector,
    and the next quantize() reads the new weights."""
    _, _, cfg, model = bridged
    infer = MaskYOLO("inference", cfg, seed=1, device="cpu")
    infer.quantize(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    assert infer._qdet is not None
    params = dict(model.net.named_parameters())
    stats = {k: v for k, v in model.net.named_buffers() if "running" in k}
    infer._load_live_state(params, stats)
    assert infer._qdet is None and infer._host_state is None
    assert torch.equal(infer.net.feature_map.weight, model.net.feature_map.weight)
    infer.quantize(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    np.testing.assert_array_equal(infer._host_state["feature_map.weight"],
                                  model.net.feature_map.weight.detach().numpy())
