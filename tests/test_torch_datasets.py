"""The port's host-side datasets and anchor tools (numpy only) vs the JAX
package's: DenseShapes, the COCO RLE JSON loader and exporter, the VIA
polygon loader, and the k-means anchors. Both packages run the same numpy
code on the same seeds and files, so everything is compared exactly."""

import json

import numpy as np
import pytest

from mask_yolo_tpu.data import coco as jcoco
from mask_yolo_tpu.data import dense_shapes as jdense
from mask_yolo_tpu.data import shapes as jshapes
from mask_yolo_tpu.data import via as jvia
from mask_yolo_tpu.utils import anchors as janchors
from mask_yolo_tpu_torch.data import coco, dense_shapes, shapes, via
from mask_yolo_tpu_torch.utils import anchors


def _dense(module, textured, count=3, seed=5, size=96, classes=80):
    ds = module.DenseShapesDataset()
    ds.load_dense(count, size, size, seed=seed, num_classes=classes, textured=textured)
    ds.prepare()
    return ds


@pytest.mark.parametrize("textured", [False, True], ids=["flat", "textured"])
def test_dense_shapes_bit_equal_to_jax(textured):
    """DenseShapesDataset: images, masks and class ids bit-equal to the JAX
    package's for the same seed, flat and textured, with 24-48 instances an
    image and classes drawn from the 80-colour palette."""
    got, want = _dense(dense_shapes, textured), _dense(jdense, textured)
    np.testing.assert_array_equal(dense_shapes.color_palette(80), jdense.color_palette(80))
    assert got.class_names == want.class_names and got.num_classes == 81
    for i in got.image_ids:
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
        gm, gc = got.load_mask(i)
        wm, wc = want.load_mask(i)
        assert gm.dtype == wm.dtype and gc.dtype == wc.dtype
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gc, wc)
        assert 10 <= gm.shape[-1] <= 48 and 1 <= gc.min() and gc.max() <= 80
    flat = _dense(dense_shapes, False)
    assert textured == (not np.array_equal(flat.load_image(0), got.load_image(0)))
    np.testing.assert_array_equal(flat.load_mask(0)[0], got.load_mask(0)[0])


def _rle_to_string(counts):
    """COCO's compressed RLE string (tests/test_coco.py): counts from index 3
    on delta-coded against counts[i-2], then a little-endian base-32 varint
    (5 value bits and a continuation bit, ASCII offset 48)."""
    s = []
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        while True:
            ch = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (ch & 0x10)) and not (x == -1 and (ch & 0x10))
            s.append(chr((ch | 0x20 if more else ch) + 48))
            if not more:
                break
    return "".join(s)


def test_rle_round_trips_equal_jax(rng):
    """rle_encode, rle_decode_counts and the compressed string form: the
    port's equal the JAX package's on random and on edge-case masks, and
    invert."""
    masks = [rng.rand(37, 53) > 0.6, np.zeros((5, 7), bool), np.ones((4, 3), bool),
             np.eye(9, dtype=bool)]
    for m in masks:
        counts = coco.rle_encode(m)
        assert counts == jcoco.rle_encode(m)
        np.testing.assert_array_equal(coco.rle_decode_counts(counts, m.shape), m)
        s = _rle_to_string(counts)
        assert coco.rle_from_string(s) == jcoco.rle_from_string(s) == list(counts)
        for seg in ({"size": list(m.shape), "counts": counts},
                    {"size": list(m.shape), "counts": s}):
            np.testing.assert_array_equal(coco.decode_segmentation(seg, m.shape), m)
            np.testing.assert_array_equal(jcoco.decode_segmentation(seg, m.shape), m)
    poly = [[2.0, 2.0, 20.0, 3.0, 12.0, 18.0]]
    np.testing.assert_array_equal(coco.decode_segmentation(poly, (24, 24)),
                                  jcoco.decode_segmentation(poly, (24, 24)))


def test_dataset_to_coco_json_and_load_coco_equal_jax(tmp_path):
    """dataset_to_coco_json → CocoDataset.load_coco on files written in the
    test: the port's annotation JSON and images equal the JAX package's byte
    for byte, the reloaded masks, classes and images equal the source's, and
    write_images=False (the port's own switch) writes the same JSON and no
    image."""
    src, jsrc = shapes.ShapesDataset(), jshapes.ShapesDataset()
    for d in (src, jsrc):
        d.load_shapes(3, 64, 64, seed=4)
        d.prepare()
    ann = coco.dataset_to_coco_json(src, str(tmp_path / "port"))
    jann = jcoco.dataset_to_coco_json(jsrc, str(tmp_path / "jax"))
    assert json.load(open(ann)) == json.load(open(jann))
    only = coco.dataset_to_coco_json(src, str(tmp_path / "json_only"), write_images=False)
    assert json.load(open(only)) == json.load(open(ann))
    assert not (tmp_path / "json_only" / "images").exists()

    got, want = coco.CocoDataset(), jcoco.CocoDataset()
    got.load_coco(ann, str(tmp_path / "port" / "images"))
    want.load_coco(jann, str(tmp_path / "jax" / "images"))
    got.prepare()
    want.prepare()
    assert got.class_names == want.class_names and len(got.image_ids) == len(want.image_ids)
    for i in got.image_ids:
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
        np.testing.assert_array_equal(got.load_image(i), src.load_image(i))
        gm, gc = got.load_mask(i)
        wm, wc = want.load_mask(i)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gc, wc)
        sm, sc = src.load_mask(i)
        np.testing.assert_array_equal(gm, sm[..., sm.any(axis=(0, 1))])
    assert coco.coco_category_map(ann) == jcoco.coco_category_map(jann)


def test_detections_to_coco_results_equal_jax(rng):
    boxes = np.asarray([[4.0, 6.0, 30.0, 40.0], [10.0, 10.0, 20.0, 22.0]])
    masks = rng.rand(48, 48, 2) > 0.5
    args = (7, boxes, [1, 3], [0.9, 0.4])
    for kwargs in ({}, {"masks": masks}, {"masks": masks, "scale": (0.5, 0.75)},
                   {"category_map": {1: 11, 3: 33}}):
        assert coco.detections_to_coco_results(*args, **kwargs) == \
            jcoco.detections_to_coco_results(*args, **kwargs)


@pytest.fixture()
def via_dir(tmp_path, rng):
    """A tiny VIA dataset: 2 images with polygon regions (2.x list format
    and 1.x dict format), and an entry without regions."""
    from PIL import Image

    d = tmp_path / "train"
    d.mkdir()
    ann = {}
    for i in range(2):
        name = f"img{i}.png"
        Image.fromarray((rng.rand(60, 80, 3) * 255).astype(np.uint8)).save(d / name)
        regions = [
            {"shape_attributes": {"name": "polygon", "all_points_x": [10, 40, 25],
                                  "all_points_y": [10, 12, 35]}},
            {"shape_attributes": {"name": "polygon", "all_points_x": [50, 70, 70, 50],
                                  "all_points_y": [20, 20, 50, 50]}}]
        if i == 1:
            regions = {str(j): r for j, r in enumerate(regions)}
        ann[name] = {"filename": name, "regions": regions}
    ann["empty.png"] = {"filename": "empty.png", "regions": []}
    with open(d / "via_test_annotation.json", "w") as f:
        json.dump(ann, f)
    return str(tmp_path)


def test_via_dataset_equals_jax(via_dir, rng):
    """ViaDataset on a VIA json written in the test: images, polygon masks
    and class ids equal the JAX package's; color_splash too; the Rice and
    Food configs carry the same values on the port's own Config."""
    got, want = via.ViaDataset(), jvia.ViaDataset()
    for d in (got, want):
        d.load_via(via_dir, "train")
        d.prepare()
    assert len(got.image_ids) == len(want.image_ids) == 2
    assert got.class_names == want.class_names
    for i in got.image_ids:
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
        gm, gc = got.load_mask(i)
        wm, wc = want.load_mask(i)
        assert gm.shape == (60, 80, 2) and gm[30, 60, 1] and not gm[30, 60, 0]
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(via.color_splash(got.load_image(i), gm),
                                      jvia.color_splash(want.load_image(i), wm))
    for name in ("RiceConfig", "FoodConfig", "ViaConfig"):
        g, w = getattr(via, name)(), getattr(jvia, name)()
        assert type(g).__mro__[-2].__module__ == "mask_yolo_tpu_torch.config"
        for key in ("NAME", "NUM_CLASSES", "IMAGE_SHAPE", "ANCHORS", "LABELS", "N_BOX"):
            assert getattr(g, key) == getattr(w, key), (name, key)


def test_anchor_tools_equal_jax(rng):
    """kmeans_anchors, gen_anchors, sweep_k, boxes_to_wh and wh_iou_matrix
    give the JAX package's values (seeded numpy in both)."""
    wh = np.abs(rng.randn(200, 2)) * 0.2 + 0.05
    for k in (1, 3, 5):
        gc, gi = anchors.kmeans_anchors(wh, k, seed=3)
        wc, wi = janchors.kmeans_anchors(wh, k, seed=3)
        np.testing.assert_array_equal(gc, wc)
        assert gi == wi
    np.testing.assert_array_equal(anchors.wh_iou_matrix(wh[:7], wh[7:10]),
                                  janchors.wh_iou_matrix(wh[:7], wh[7:10]))
    boxes = np.concatenate([rng.rand(20, 2) * 50, 50 + rng.rand(20, 2) * 50], axis=1)
    boxes[3] = [5, 5, 5, 9]                           # degenerate: filtered
    got_wh = anchors.boxes_to_wh(boxes, (100, 100, 3))
    np.testing.assert_array_equal(got_wh, janchors.boxes_to_wh(boxes, (100, 100, 3)))
    assert len(got_wh) == 19
    got, want = anchors.gen_anchors(got_wh, 3, 7, seed=1), janchors.gen_anchors(got_wh, 3, 7, seed=1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert anchors.sweep_k(wh, 4, seed=0) == janchors.sweep_k(wh, 4, seed=0)


def test_anchors_from_dataset_reads_the_ports_loader():
    """anchors_from_dataset runs over the port's data/loader.load_image_gt
    and gives the JAX package's anchors for the same Shapes dataset."""
    from mask_yolo_tpu.data.shapes import ShapesConfig as JCfg
    from mask_yolo_tpu_torch.data.shapes import ShapesConfig as PCfg

    ds, jds = shapes.ShapesDataset(), jshapes.ShapesDataset()
    for d in (ds, jds):
        d.load_shapes(6, 224, 224, seed=2)
        d.prepare()
    got = anchors.anchors_from_dataset(ds, PCfg(), 3, seed=0)
    want = janchors.anchors_from_dataset(jds, JCfg(), 3, seed=0)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
