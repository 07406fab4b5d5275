"""The port's Keras-h5 interop (utils/keras_h5.py, MaskYOLO.
load_weights_from_keras_h5, a `.h5` yolo_pretrain_dir) vs the JAX package's,
on files written in the test. The loader itself is numpy + h5py and must
give the JAX package's trees exactly; the loaded models are compared at the
tolerance of test_torch_slice.py (rtol 1e-4, atol 1e-5: two f32 conv
stacks that sum in different orders)."""

import warnings

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_yolo_tpu import MaskYOLO as JaxMaskYOLO
from mask_yolo_tpu.utils import keras_h5 as jkeras_h5
from mask_yolo_tpu_torch import MaskYOLO, weights
from mask_yolo_tpu_torch.utils import keras_h5
from test_torch_quant import JaxQ, PortQ, spread_variables

torch.set_num_threads(2)


def _leaves(tree, path=()):
    for k in sorted(tree):
        if hasattr(tree[k], "items"):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield path + (k,), np.asarray(tree[k])


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    """The spread tree of test_torch_quant.py written by the JAX package's
    save_keras_h5."""
    v, _, _ = spread_variables()
    path = str(tmp_path_factory.mktemp("h5") / "weights.h5")
    jkeras_h5.save_keras_h5(path, v["params"], v["batch_stats"])
    return v, path


def test_load_keras_h5_equals_jax(h5_file):
    """load_keras_h5: params, batch_stats and the report (loaded, skipped,
    loaded_paths) equal the JAX package's on the same file, and the loaded
    leaves equal what was saved."""
    v, path = h5_file
    got, want = keras_h5.load_keras_h5(path), jkeras_h5.load_keras_h5(path)
    for g, w in zip(got[:2], want[:2]):
        g, w = dict(_leaves(g)), dict(_leaves(w))
        assert g.keys() == w.keys() and len(g) > 50
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=str(key))
    assert got[2] == want[2] and not got[2]["skipped"]
    saved = dict(_leaves(v["params"]))
    for key, value in _leaves(got[0]):
        np.testing.assert_array_equal(value, saved[key], err_msg=str(key))


def test_model_loaded_from_h5_detects_like_the_jax_model(h5_file, rng):
    """The h5 file loads into the port (through the flax-layout tree and the
    weight bridge, so the deconv follows flax) with detect_outputs equal to
    the JAX model's that loaded the same file."""
    _, path = h5_file
    jmodel = JaxMaskYOLO("inference", JaxQ())
    jreport = jmodel.load_weights_from_keras_h5(path)
    model = MaskYOLO("inference", PortQ(), device="cpu")
    before = model.net.state_dict()["mask.mask_deconv.weight"].clone()
    report = model.load_weights_from_keras_h5(path)
    assert report == jreport and not report["shape_mismatch"]
    assert not torch.equal(model.net.state_dict()["mask.mask_deconv.weight"], before)
    images = rng.rand(3, *JaxQ.IMAGE_SHAPE).astype(np.float32)
    want = {k: np.asarray(a) for k, a in jax.device_get(
        jmodel.detect_batch(jnp.asarray(images))).items()}
    got = {k: t.numpy() for k, t in model.detect_batch(images).items()}
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-5)
    assert (got["masks"] == want["masks"]).mean() > 0.999
    assert got["masks"].any()


def test_ports_save_round_trips_through_jax(h5_file, tmp_path):
    """The port's save_keras_h5 on the tree of its own weights → the JAX
    package's load_keras_h5: every leaf returns bit-exact, and the two
    packages write identical files."""
    v, path = h5_file
    model = MaskYOLO("inference", PortQ(), device="cpu")
    model.load_jax_variables(v)
    tree = weights.to_jax_variables(model._host_state)
    out = str(tmp_path / "port.h5")
    keras_h5.save_keras_h5(out, tree["params"], tree["batch_stats"])
    params, stats, report = jkeras_h5.load_keras_h5(out)
    assert not report["skipped"]
    for loaded, saved in ((params, v["params"]), (stats, v["batch_stats"])):
        saved = dict(_leaves(saved))
        for key, value in _leaves(loaded):
            np.testing.assert_array_equal(value, saved[key], err_msg=str(key))
    with h5py.File(out, "r") as a, h5py.File(path, "r") as b:
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        for name in a:
            assert list(a[name].attrs["weight_names"]) == list(b[name].attrs["weight_names"])
            for wn in a[name].attrs["weight_names"]:
                np.testing.assert_array_equal(a[name][wn.decode()], b[name][wn.decode()])


def test_skipped_layers_and_exclude_report_like_jax(h5_file, tmp_path):
    """A file with an unknown layer and one shape mismatch: both packages
    warn and report the same skipped layers and mismatches; exclude=["mask"]
    leaves the mask head as it was."""
    v, path = h5_file
    bad = str(tmp_path / "bad.h5")
    with h5py.File(path, "r") as src, h5py.File(bad, "w") as dst:
        names = list(src.attrs["layer_names"]) + [b"some_unknown_layer"]
        for name in src:
            src.copy(name, dst)
        g = dst.create_group("some_unknown_layer")
        g.create_dataset("some_unknown_layer/kernel:0", data=np.zeros((1, 1, 2, 2), np.float32))
        g.attrs["weight_names"] = np.array([b"some_unknown_layer/kernel:0"])
        del dst["conv_23"]["conv_23/kernel:0"]
        dst["conv_23"].create_dataset("conv_23/kernel:0", data=np.zeros((1, 1, 8, 3), np.float32))
        dst.attrs["layer_names"] = np.array(names)
    jmodel = JaxMaskYOLO("inference", JaxQ())
    model = MaskYOLO("inference", PortQ(), device="cpu")
    mask_before = {k: t.clone() for k, t in model.net.state_dict().items()
                   if k.startswith("mask.")}
    with pytest.warns(UserWarning, match="keras_h5"):
        jreport = jmodel.load_weights_from_keras_h5(bad, exclude=["mask"])
    with pytest.warns(UserWarning, match="keras_h5"):
        report = model.load_weights_from_keras_h5(bad, exclude=["mask"])
    assert report == jreport
    assert report["skipped"] and len(report["shape_mismatch"]) == 1
    for k, t in mask_before.items():
        assert torch.equal(model.net.state_dict()[k], t), k
    got = model.net.state_dict()["backbone.conv1.conv.weight"].numpy()
    np.testing.assert_array_equal(
        got, weights.convert_kernel("conv", v["params"]["backbone"]["conv1"]["conv"]["kernel"]))


def test_yolo_pretrain_dir_h5(h5_file, tmp_path):
    """MaskYOLO(yolo_pretrain_dir="*.h5") loads the file at construction; a
    file without YOLO-branch weights raises, as in the JAX package."""
    v, path = h5_file
    model = MaskYOLO("training", PortQ(), model_dir=str(tmp_path), yolo_pretrain_dir=path,
                     yolo_trainable=False, device="cpu")
    np.testing.assert_array_equal(
        model.net.state_dict()["yolo.conv_23.weight"].numpy(),
        weights.convert_kernel("conv_23", v["params"]["yolo"]["conv_23"]["kernel"]))
    empty = str(tmp_path / "no_yolo.h5")
    with h5py.File(empty, "w") as f:
        g = f.create_group("some_unknown_layer")
        g.create_dataset("some_unknown_layer/kernel:0", data=np.zeros((1, 1, 2, 2), np.float32))
        g.attrs["weight_names"] = np.array([b"some_unknown_layer/kernel:0"])
        f.attrs["layer_names"] = np.array([b"some_unknown_layer"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="no YOLO-branch"):
            MaskYOLO("training", PortQ(), model_dir=str(tmp_path), yolo_pretrain_dir=empty,
                     device="cpu")
