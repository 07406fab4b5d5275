"""The port's utils/visualize.py (matplotlib on the Agg backend) against the
JAX package's: the numpy helpers bit-equal, the figures written to the same
size as the JAX package's for the same inputs, and the facade's display
switches (detect / infer_yolo with display=True, the default)."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from mask_yolo_tpu.utils import visualize as jvisualize
from mask_yolo_tpu_torch import MaskYOLO, weights
from mask_yolo_tpu_torch.utils import visualize
from test_torch_slice import PortTiny

torch.set_num_threads(2)


def _scene(rng):
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    boxes = np.array([[5, 5, 30, 30], [20, 20, 50, 55]], dtype=np.float32)
    masks = np.zeros((64, 64, 2), dtype=bool)
    masks[8:28, 8:28, 0] = True
    masks[25:50, 25:45, 1] = True
    return image, boxes, masks


def _same_png(a, b):
    """Two PNG files hold the same pixels."""
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def test_numpy_helpers_bit_equal(rng):
    """random_colors(seed=), apply_mask and draw_box give the JAX package's
    arrays exactly."""
    for n, seed in ((5, 0), (12, 3)):
        assert visualize.random_colors(n, seed=seed) == jvisualize.random_colors(n, seed=seed)
    assert len(set(visualize.random_colors(5, seed=0))) == 5
    image, _, masks = _scene(rng)
    color = visualize.random_colors(3, seed=1)[2]
    np.testing.assert_array_equal(
        visualize.apply_mask(image.astype(np.float32).copy(), masks[..., 0], color),
        jvisualize.apply_mask(image.astype(np.float32).copy(), masks[..., 0], color))
    a, b = np.zeros((32, 32, 3), np.uint8), np.zeros((32, 32, 3), np.uint8)
    visualize.draw_box(a, (4, 6, 20, 25), (255, 0, 0), thickness=2)
    jvisualize.draw_box(b, (4, 6, 20, 25), (255, 0, 0), thickness=2)
    np.testing.assert_array_equal(a, b)
    assert (a[6:8, 4:21, 0] == 255).all() and a[15, 12, 0] == 0


@pytest.mark.parametrize("what", ["display_instances", "draw_boxes_mpl", "display_top_masks",
                                  "plot_precision_recall", "plot_overlaps",
                                  "display_differences", "draw_rois", "draw_boxes"])
def test_figures_equal_the_jax_packages(tmp_path, what):
    """Each drawing function writes the file tests/test_visualize.py checks,
    with the same pixels as the JAX package's function on the same inputs."""
    paths = []
    for mod, name in ((visualize, "port.png"), (jvisualize, "jax.png")):
        rng = np.random.RandomState(3)
        image, boxes, masks = _scene(rng)
        out = str(tmp_path / name)
        labels = ["bg", "a", "b"]
        if what == "display_instances":
            mod.display_instances(image, boxes, masks, np.array([1, 2]), labels,
                                  np.array([0.9, 0.8]), save_path=out)
        elif what == "draw_boxes_mpl":
            mod.draw_boxes_mpl(image, [{"xmin": 0.1, "ymin": 0.1, "xmax": 0.5, "ymax": 0.5,
                                        "score": 0.7, "label": 1}], labels, save_file=out)
        elif what == "display_top_masks":
            mod.display_top_masks(image, rng.rand(64, 64, 3) > 0.5, np.array([1, 1, 2]), labels,
                                  save_path=out)
        elif what == "plot_precision_recall":
            mod.plot_precision_recall(0.8, [1.0, 0.8, 0.6], [0.0, 0.5, 1.0], save_path=out)
        elif what == "plot_overlaps":
            mod.plot_overlaps(np.array([1, 2]), np.array([1]), np.array([0.9]), rng.rand(1, 2),
                              labels, save_path=out)
        elif what == "display_differences":
            pred_boxes = np.array([[6, 6, 31, 31], [40, 40, 60, 60]], dtype=np.float32)
            pred_masks = np.zeros((64, 64, 2), bool)
            pred_masks[8:28, 8:28, 0] = True
            pred_masks[42:58, 42:58, 1] = True
            _, pred_match, _ = mod.display_differences(
                image, boxes[:1], np.array([1]), masks[..., :1], pred_boxes, np.array([1, 2]),
                np.array([0.9, 0.8]), pred_masks, labels, save_path=out)
            assert pred_match[0] == 0 and pred_match[1] == -1
        elif what == "draw_rois":
            rois = (rng.rand(20, 4) * 32).astype(np.float32)
            rois[:, 2:] += rois[:, :2]
            mod.draw_rois(image, rois, rois + 2, rng.rand(64, 64, 20) > 0.8,
                          rng.randint(0, 3, 20), labels, limit=8, save_path=out)
        else:
            mod.draw_boxes(image, boxes=boxes, refined_boxes=boxes + 2, masks=masks,
                           captions=["a", "b"], visibilities=[2, 1], title="t", save_path=out)
        paths.append(out)
    _same_png(*paths)


def test_display_weight_stats_takes_a_state_dict_or_a_tree(capsys):
    """The same table from the network's state_dict(), from a nested dict of
    arrays (the JAX package's input, same rows in the same order), and the
    dead / overflow flags."""
    params = {"layer": {"kernel": np.ones((3, 3)), "bias": np.zeros(3)}}
    rows = visualize.display_weight_stats(params)
    assert rows == jvisualize.display_weight_stats(params)
    assert len(rows) == 3 and "dead?" in capsys.readouterr().out
    net = MaskYOLO("inference", PortTiny(), device="cpu").net
    state = net.state_dict()
    rows = visualize.display_weight_stats(state)
    floats = [k for k, v in state.items() if v.dim() > 0]
    assert [r[0] for r in rows[1:]] == sorted(floats)
    tree = weights.to_jax_variables({k: v.numpy() for k, v in state.items()})
    n_params = sum(1 for k in floats if "running" not in k)
    assert len(visualize.display_weight_stats(tree["params"])) == 1 + n_params
    big = {"w": np.full((2, 2), 2000.0)}
    assert "Overflow" in visualize.display_weight_stats(big)[1][-1]


def test_facade_draws_by_default(tmp_path, rng):
    """detect and infer_yolo draw by default (the JAX package's signature):
    each writes one figure into save_path; display=False writes none."""
    model = MaskYOLO("inference", PortTiny(), device="cpu")
    image = (rng.rand(*PortTiny.IMAGE_SHAPE) * 255).astype(np.uint8)
    res = model.detect(image, save_path=str(tmp_path / "det"), cs_threshold=0.0)
    files = list((tmp_path / "det").iterdir())
    assert len(files) == 1 and files[0].name.startswith("InferMaskYOLO-tiny-")
    assert files[0].stat().st_size > 0 and "full_masks" in res[0]
    model.infer_yolo(image, save_path=str(tmp_path / "yolo"))
    files = list((tmp_path / "yolo").iterdir())
    assert len(files) == 1 and files[0].name.startswith("InferYOLO-")
    model.detect(image, save_path=str(tmp_path / "none"), display=False)
    model.infer_yolo(image, save_path=str(tmp_path / "none"), display=False)
    assert not (tmp_path / "none").exists()


def test_generators_debug_mode_draws_the_boxes(rng):
    """BatchGenerator(norm=False) and data_generator(norm=False): 0..255
    float images with the GT boxes drawn, equal to the JAX package's debug
    batch for the same data."""
    from mask_yolo_tpu.data import pipeline as jpipeline
    from mask_yolo_tpu.data.shapes import ShapesDataset as JShapes
    from mask_yolo_tpu_torch.data import pipeline
    from mask_yolo_tpu_torch.data.shapes import ShapesDataset
    from test_torch_quant import JaxQ, PortQ

    ds, jds = ShapesDataset(), JShapes()
    for d in (ds, jds):
        d.load_shapes(4, 64, 64, seed=1)
        d.prepare()
    got = pipeline.BatchGenerator(pipeline.preload_dataset(ds, PortQ()), PortQ(),
                                  shuffle=False, norm=False)[0]
    want = jpipeline.BatchGenerator(jpipeline.preload_dataset(jds, JaxQ()), JaxQ(),
                                    shuffle=False, norm=False)[0]
    assert got["image"].dtype == np.float32 and got["image"].max() > 1.5
    np.testing.assert_array_equal(got["image"], want["image"])
    drawn = next(pipeline.data_generator(ds, PortQ(), shuffle=False, norm=False, workers=0))
    jdrawn = next(jpipeline.data_generator(jds, JaxQ(), shuffle=False, norm=False, workers=0))
    np.testing.assert_array_equal(drawn["image"], jdrawn["image"])
