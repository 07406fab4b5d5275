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
    ds, _ = both(1, 64, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_image_gt(ds, port_config(ShapesTiny()), 0, augmentation=lambda im, m: (im, m))


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
