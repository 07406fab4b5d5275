"""The port's data path (a numpy copy of the JAX package's) gives the JAX
package's arrays bit for bit: Shapes images and masks for a seed, the YOLO
target encoding, preloaded datasets and training batches. Also the CPU path
of the device prefetcher."""

import numpy as np
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu.data import encoder as jencoder
from mask_yolo_tpu.data import pipeline as jpipeline
from mask_yolo_tpu.data.shapes import ShapesConfig as JaxShapesConfig
from mask_yolo_tpu.data.shapes import ShapesDataset as JaxShapesDataset
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.data import encoder, pipeline
from mask_yolo_tpu_torch.data.loader import load_image_gt
from mask_yolo_tpu_torch.data.prefetch import DevicePrefetcher
from mask_yolo_tpu_torch.data.shapes import ShapesConfig, ShapesDataset


class ShapesTiny(TinyConfig):
    NUM_CLASSES = 4
    LABELS = ["background", "square", "circle", "triangle"]
    MINI_MASK_SHAPE = (16, 16)


def port_config(jax_config, **over):
    values = {k: getattr(jax_config, k) for k in dir(jax_config) if k.isupper()}
    values.update(over)
    return type("Port" + type(jax_config).__name__, (Config,), values)()


def both(count, size, seed):
    out = []
    for cls in (ShapesDataset, JaxShapesDataset):
        ds = cls()
        ds.load_shapes(count, size, size, seed=seed)
        ds.prepare()
        out.append(ds)
    return out


@pytest.mark.parametrize("size,seed", [(64, 2), (224, 0)])
def test_shapes_dataset_matches_jax(size, seed):
    mine, theirs = both(4, size, seed)
    np.testing.assert_equal(mine.image_info, theirs.image_info)
    for i in mine.image_ids:
        np.testing.assert_array_equal(mine.load_image(i), theirs.load_image(i))
        for a, b in zip(mine.load_mask(i), theirs.load_mask(i)):
            np.testing.assert_array_equal(a, b)


def test_encode_batch_matches_jax(rng):
    cfg = ShapesTiny()
    boxes = (rng.rand(3, cfg.MAX_GT_INSTANCES, 4) * 40).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] + 4
    boxes[:, -1] = 0.0
    ids = rng.randint(1, cfg.NUM_CLASSES, (3, cfg.MAX_GT_INSTANCES)).astype(np.int32)
    for a, b in zip(encoder.encode_batch(boxes, ids, port_config(cfg)),
                    jencoder.encode_batch(boxes, ids, cfg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("jcfg", [ShapesTiny(), JaxShapesConfig()], ids=["tiny", "shapes224"])
def test_preload_and_batches_match_jax(jcfg):
    """Full-size masks at TinyConfig, mini-masks at ShapesConfig's 224²."""
    size = jcfg.IMAGE_SHAPE[0]
    cfg = port_config(jcfg)
    mine, theirs = both(5, size, 3)
    data = pipeline.preload_dataset(mine, cfg)
    jdata = jpipeline.preload_dataset(theirs, jcfg)
    assert data.keys() == jdata.keys()
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k], err_msg=k)
    for mode in ("training", "yolo"):
        gen = pipeline.BatchGenerator(data, cfg, mode=mode, shuffle=True, seed=4)
        jgen = jpipeline.BatchGenerator(jdata, jcfg, mode=mode, shuffle=True, seed=4)
        assert len(gen) == len(jgen)
        for epoch in range(2):
            for i in range(len(gen)):
                a, b = gen[i], jgen[i]
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{mode} {k}")
            gen.on_epoch_end()
            jgen.on_epoch_end()


def test_shapes_config_copy_matches_jax():
    mine, theirs = ShapesConfig(), JaxShapesConfig()
    for k in dir(theirs):
        if k.isupper():
            assert getattr(mine, k) == getattr(theirs, k), k


def test_loader_augmentation_raises_naming_its_roadmap_item():
    """augmentation= is ported and no longer raises: a bare callable is
    applied to image and mask before the boxes are taken."""
    ds, _ = both(1, 64, 0)
    cfg = port_config(ShapesTiny())
    plain = load_image_gt(ds, cfg, 0)
    flipped = load_image_gt(ds, cfg, 0, augmentation=lambda im, m: (im[:, ::-1], m[:, ::-1]))
    np.testing.assert_array_equal(flipped[0], plain[0][:, ::-1])
    np.testing.assert_array_equal(flipped[3], plain[3][:, ::-1])
    np.testing.assert_array_equal(flipped[2][:, [0, 2]], 64 - plain[2][:, [2, 0]])


def test_prefetcher_passes_cpu_batches_through():
    cfg = port_config(ShapesTiny())
    ds, _ = both(4, 64, 1)
    gen = pipeline.BatchGenerator(pipeline.preload_dataset(ds, cfg), cfg, shuffle=False)
    got = list(DevicePrefetcher(gen, "cpu", size=2))
    assert len(got) == len(gen) == 2
    for i, batch in enumerate(got):
        for k, v in batch.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), gen[i][k])


# ---- augmentation, the endless generator, pooled workers, native ops ---------

import glob                                                    # noqa: E402
import os                                                      # noqa: E402

from mask_yolo_tpu.data import augment as jaugment            # noqa: E402
from mask_yolo_tpu.data import loader as jloader              # noqa: E402
from mask_yolo_tpu_torch import MaskYOLO, native               # noqa: E402
from mask_yolo_tpu_torch.data import augment, loader           # noqa: E402
from mask_yolo_tpu_torch.utils import image as image_ops       # noqa: E402

AUGMENTERS = {
    "fliplr": lambda m: m.Fliplr(0.5), "flipud": lambda m: m.Flipud(0.5),
    "rot90": lambda m: m.Rot90(), "scale": lambda m: m.Scale((0.8, 1.25)),
    "brightness": lambda m: m.Brightness((0.7, 1.3)), "contrast": lambda m: m.Contrast((0.7, 1.3)),
    "sequential": lambda m: m.Sequential([m.Fliplr(0.5), m.Rot90(), m.Scale((0.9, 1.1)),
                                          m.Brightness((0.8, 1.2))], seed=7),
    "default": lambda m: m.default_augmenter(seed=5),
}


def _sample(seed=3, shape=(48, 48)):
    rng = np.random.RandomState(seed)
    image = (rng.rand(*shape, 3) * 255).astype(np.uint8)
    mask = np.zeros((*shape, 2), bool)
    mask[5:20, 8:30, 0] = True
    mask[25:44, 3:17, 1] = True
    return image, mask


@pytest.mark.parametrize("name", list(AUGMENTERS))
def test_augmenters_equal_jax(name):
    """Each augmenter, driven by the same seeded stream, gives the JAX
    package's image and mask bit for bit, over several draws."""
    ours, theirs = AUGMENTERS[name](augment), AUGMENTERS[name](jaugment)
    assert ours.affects_mask == theirs.affects_mask
    image, mask = _sample()
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(6):
        gi, gm = ours(image, mask, r1)
        wi, wm = theirs(image, mask, r2)
        assert gi.dtype == wi.dtype and gm.dtype == wm.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    if name in ("sequential", "default"):      # and on their own seeded streams
        for _ in range(3):
            (gi, gm), (wi, wm) = ours(image, mask), theirs(image, mask)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)


class _DuckFliplr:
    """An imgaug-style augmenter (duck-typed on augment_image)."""

    def to_deterministic(self):
        return self

    def augment_image(self, image, hooks=None):
        return image[:, ::-1]


def test_imgaug_style_augmenters_are_adapted():
    image, mask = _sample()
    adapter = augment.as_augmenter(_DuckFliplr())
    assert isinstance(adapter, augment.ImgaugAdapter)
    out_image, out_mask = adapter(image, mask)
    np.testing.assert_array_equal(out_image, image[:, ::-1])
    np.testing.assert_array_equal(out_mask, mask[:, ::-1])
    assert out_mask.dtype == bool
    with pytest.raises(TypeError):
        augment.as_augmenter(object())


def test_imgaug_adapter_with_imgaug_itself():
    iaa = pytest.importorskip("imgaug.augmenters", reason="imgaug is not installed")
    image, mask = _sample()
    out_image, out_mask = augment.ImgaugAdapter(iaa.Fliplr(1.0))(image, mask)
    np.testing.assert_array_equal(out_image, image[:, ::-1])
    np.testing.assert_array_equal(out_mask, mask[:, ::-1])


def test_load_image_gt_with_augmentation_equals_jax():
    ds, jds = both(3, 64, 4)
    jcfg = ShapesTiny()
    cfg = port_config(jcfg)
    ours, theirs = augment.default_augmenter(seed=9), jaugment.default_augmenter(seed=9)
    for image_id in range(3):
        got = load_image_gt(ds, cfg, image_id, augmentation=ours)
        want = jloader.load_image_gt(jds, jcfg, image_id, augmentation=theirs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_loader_helpers_equal_jax(rng):
    jcfg = ShapesTiny()
    cfg = port_config(jcfg)
    ds, _ = both(1, 64, 6)
    _, _, bbox, mask = load_image_gt(ds, cfg, 0, use_mini_mask=False)
    mini = loader.minimize_mask(bbox, mask, (16, 16))
    np.testing.assert_array_equal(loader.expand_mask(bbox, mini, (64, 64)),
                                  jloader.expand_mask(bbox, mini, (64, 64)))
    images = (rng.rand(2, 8, 8, 3) * 255).astype(np.uint8)
    molded = loader.mold_image(images, cfg)
    np.testing.assert_array_equal(molded, jloader.mold_image(images, jcfg))
    np.testing.assert_array_equal(loader.unmold_image(molded, cfg), images)
    np.testing.assert_array_equal(loader.compute_backbone_shapes(cfg),
                                  jloader.compute_backbone_shapes(jcfg))


def _batches(gen, count):
    out = [next(gen) for _ in range(count)]
    gen.close()
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("workers", [0, 2], ids=["inline", "two_workers"])
@pytest.mark.parametrize("mode", ["training", "yolo"])
def test_data_generator_batches_equal_jax(workers, mode):
    """The endless generator with default_augmenter, 5 images in batches of
    2 over two and a half passes (two reshuffles): bit-equal to the JAX
    package's for the same seed, inline and on two loader threads."""
    ds, jds = both(5, 64, 8)
    jcfg = ShapesTiny()
    cfg = port_config(jcfg)
    got = _batches(pipeline.data_generator(
        ds, cfg, shuffle=True, augmentation=augment.default_augmenter(seed=3), mode=mode,
        seed=4, workers=workers), 6)
    want = _batches(jpipeline.data_generator(
        jds, jcfg, shuffle=True, augmentation=jaugment.default_augmenter(seed=3), mode=mode,
        seed=4, workers=workers), 6)
    _assert_batches_equal(got, want)
    assert got[0]["image"].shape == (2, 64, 64, 3) and got[0]["image"].dtype == np.uint8
    assert ("gt_masks" in got[0]) == (mode == "training")


@pytest.mark.parametrize("pool_mode", ["thread", "process"])
def test_batches_do_not_depend_on_the_worker_count(pool_mode):
    """Per-image seeds are drawn at submission, so 1, 2 and 4 worker threads,
    and 1 and 2 forked processes, give the same augmented batches (the JAX
    package's contract; its inline stream threads one RandomState through
    and differs from the pooled one once augmentation draws)."""
    ds, _ = both(5, 64, 8)
    runs = []
    for workers in (1, 2, 4) if pool_mode == "thread" else (1, 2):   # few forks in a test
        cfg = port_config(ShapesTiny(), DATA_WORKERS=workers, DATA_WORKER_MODE=pool_mode)
        runs.append(_batches(pipeline.data_generator(
            ds, cfg, shuffle=True, augmentation=augment.default_augmenter(seed=3), seed=4), 5))
    for run in runs[1:]:
        _assert_batches_equal(run, runs[0])


def test_data_workers_0_and_2_give_the_same_batches_without_random_draws():
    """DATA_WORKERS 0 against 2: bit-equal wherever the stream draws no
    random number per image (no shuffle, a deterministic augmentation)."""
    ds, _ = both(5, 64, 8)
    flip = lambda image, mask: (image[:, ::-1], mask[:, ::-1])          # noqa: E731
    runs = [_batches(pipeline.data_generator(
        ds, port_config(ShapesTiny(), DATA_WORKERS=workers), shuffle=False, augmentation=flip), 5)
        for workers in (0, 2)]
    _assert_batches_equal(runs[1], runs[0])


def test_generator_skips_a_failing_image_and_gives_up_after_the_limit():
    ds, _ = both(4, 64, 8)
    cfg = port_config(ShapesTiny(), DATA_WORKERS=2)
    calls = {"n": 0}

    def sometimes(image, mask):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("bad image")
        return image, mask

    batch = _batches(pipeline.data_generator(ds, cfg, shuffle=False, augmentation=sometimes,
                                             workers=0), 1)[0]
    assert batch["image"].shape[0] == 2 and calls["n"] == 3

    def always(image, mask):
        raise RuntimeError("bad image")

    with pytest.raises(RuntimeError, match="bad image"):
        next(pipeline.data_generator(ds, cfg, shuffle=False, augmentation=always, workers=0,
                                     error_limit=2))
    with pytest.raises(NotImplementedError, match="#5"):
        next(pipeline.data_generator(ds, cfg, norm=False))
    with pytest.raises(ValueError, match="DATA_WORKER_MODE"):
        next(pipeline.data_generator(ds, port_config(ShapesTiny(), DATA_WORKER_MODE="fiber"),
                                     workers=2))


# the native image ops against their numpy twins (as tests/test_native.py)

@pytest.fixture
def numpy_twins(monkeypatch):
    """A switch of utils/image.py to its numpy paths; skips where the
    native library did not build (decided here, not at import)."""
    if not native.available():
        pytest.skip("no C++ compiler: the native image ops did not build")
    return lambda: monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("shape,out", [((17, 23, 3), (64, 64)), ((224, 224, 3), (100, 150)),
                                       ((5, 5), (11, 7)), ((56, 31, 1), (56, 62))])
@pytest.mark.parametrize("align_corners", [False, True])
def test_native_resize_bilinear_equals_numpy(shape, out, align_corners, numpy_twins):
    img = (np.random.RandomState(0).rand(*shape) * 255).astype(np.float32)
    got = image_ops.resize_bilinear(img, out, align_corners=align_corners)
    numpy_twins()
    np.testing.assert_array_equal(got, image_ops.resize_bilinear(img, out,
                                                                 align_corners=align_corners))


@pytest.mark.parametrize("zoom", [(2.0, 2.0), (0.25, 0.25), (1.7, 0.6)])
def test_native_resize_nearest_equals_numpy(zoom, numpy_twins):
    mask = np.random.RandomState(0).rand(40, 56, 5) > 0.5
    got = image_ops.resize_nearest(mask, zoom)
    numpy_twins()
    ref = image_ops.resize_nearest(mask, zoom)
    assert got.dtype == ref.dtype == bool
    np.testing.assert_array_equal(got, ref)


def test_native_rasterizers_equal_numpy(numpy_twins):
    rng = np.random.RandomState(1)
    circles = [(int(rng.randint(0, 64)), int(rng.randint(0, 64)), int(rng.randint(1, 30)))
               for _ in range(8)]
    polys = [(rng.rand(n) * 64, rng.rand(n) * 64) for n in (3, 4, 7)]
    def draw():
        canvases = []
        for c in circles:
            canvas = np.zeros((64, 64, 3), np.uint8)
            image_ops.fill_circle(canvas, *c, (255, 0, 0))
            canvases.append(canvas[..., 0] > 0)
        return canvases + [image_ops.polygon_mask(xs, ys, (64, 64)) for xs, ys in polys]

    got = draw()
    numpy_twins()
    ref = draw()
    for g, r in zip(got, ref):
        assert g.dtype == bool and g.any()
        np.testing.assert_array_equal(g, r)


def test_native_library_builds_under_the_repository(tmp_path):
    if not native.available():
        pytest.skip("no C++ compiler: the native image ops did not build")
    assert native.BUILD_DIR.name == "torch_native" and native.BUILD_DIR.parent.name == "build"
    assert glob.glob(str(native.BUILD_DIR / "image_ops_*.so"))


def test_train_with_augmentation_workers_and_profile_writes_a_trace(tmp_path):
    """MaskYOLO.train(augmentation=, profile_dir=) with DATA_WORKERS 2: the
    endless generator feeds len(train) // BATCH_SIZE steps an epoch, the
    first epoch leaves a Chrome trace of steps [2, 5), and the loader
    threads are gone afterwards."""
    import threading

    cfg = port_config(ShapesTiny(), DATA_WORKERS=2, VALIDATION_STEPS=1)
    ds, _ = both(13, 64, 1)
    val, _ = both(2, 64, 2)
    steps = []
    model = MaskYOLO("training", cfg, model_dir=str(tmp_path / "ckpt"), seed=0, device="cpu")
    model.train(ds, val, 1e-3, epochs=2, verbose=False,
                augmentation=augment.default_augmenter(seed=1),
                profile_dir=str(tmp_path / "trace"),
                custom_callbacks=[lambda e, m, vl, st: steps.append(st.step)])
    assert steps == [6, 12]                    # 13 // 2 steps an epoch
    traces = os.listdir(tmp_path / "trace")
    assert traces == ["train_steps_2_5.trace.json"]
    assert os.path.getsize(tmp_path / "trace" / traces[0]) > 1000
    # train() closed the generator: its pool is shut down without waiting, so
    # give the loader threads a moment to finish the image they were on
    for t in [t for t in threading.enumerate() if t.name.startswith("myolo-data")]:
        t.join(timeout=30)
        assert not t.is_alive()
