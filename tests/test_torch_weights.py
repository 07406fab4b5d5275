"""Weight bridge: a flax variable tree of `MaskYoloNet` → the port's state_dict.

Every flax leaf must land on a torch key and every torch key must be filled;
the transposed conv must follow flax's kernel orientation (flipped)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet
from mask_yolo_tpu_torch import weights
from mask_yolo_tpu_torch.models.network import MaskYoloNet

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_pair(tiny_config):
    cfg = tiny_config
    kw = dict(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
              top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
              mask_pool_size=cfg.MASK_POOL_SIZE)
    variables = jax.device_get(JaxNet(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *cfg.IMAGE_SHAPE)),
        jnp.zeros((1, 4, 4)), train=False))
    return variables, MaskYoloNet(**kw)


def _n_leaves(tree):
    return sum(_n_leaves(v) if hasattr(v, "items") else 1 for v in tree.values())


def test_bridge_maps_every_leaf_and_fills_every_key(tiny_pair):
    variables, net = tiny_pair
    state = weights.from_jax_variables(variables, net.state_dict().keys())
    n_bn = _n_leaves(variables["batch_stats"]) // 2     # mean + var per BN
    assert len(state) == _n_leaves(variables) + n_bn    # + num_batches_tracked
    assert set(state) == set(net.state_dict())
    # strict load: shapes line up with the torch modules
    net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    np.testing.assert_array_equal(
        net.backbone.conv1.conv.weight.detach().numpy(),
        variables["params"]["backbone"]["conv1"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        net.backbone.block1.conv_dw_bn.running_var.numpy(),
        variables["batch_stats"]["backbone"]["block1"]["conv_dw_bn"]["var"])


def test_bridge_raises_on_unmapped_leaf_and_unfilled_key(tiny_pair):
    variables, net = tiny_pair
    keys = net.state_dict().keys()
    extra = {"params": {**variables["params"],
                        "stray": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        weights.from_jax_variables(extra, keys)
    params = dict(variables["params"])
    del params["feature_map"]
    with pytest.raises(KeyError, match="feature_map"):
        weights.from_jax_variables({"params": params,
                                    "batch_stats": variables["batch_stats"]}, keys)
    bogus = {"params": {"mask": {"mask_out": {"gamma": np.zeros(3)}}}}
    with pytest.raises(KeyError, match="gamma"):
        weights.from_jax_variables(bogus, keys)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 3, 3, 4, 5), (1, 4, 6, 8, 3),
                                            (3, 5, 2, 16, 16)])
def test_deconv_bridge_follows_flax_orientation(rng, b, h, w, cin, cout):
    """flax ConvTranspose(2x2, s2) reads its kernel flipped relative to
    torch's conv_transpose2d; the bridge flips it, the plain transpose does
    not match."""
    layer = nn.ConvTranspose(cout, (2, 2), strides=(2, 2), name="mask_deconv")
    x = rng.randn(b, h, w, cin).astype(np.float32)
    kernel = rng.randn(2, 2, cin, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}}, x))

    def torch_deconv(weight):
        y = F.conv_transpose2d(torch.tensor(x).permute(0, 3, 1, 2),
                               torch.tensor(weight), torch.tensor(bias), stride=2)
        return y.permute(0, 2, 3, 1).numpy()

    got = torch_deconv(weights.convert_kernel("mask_deconv", kernel))
    # one f32 product per tap, no accumulation-order freedom beyond cin terms
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    unflipped = torch_deconv(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    assert np.abs(unflipped - want).max() > 0.5


def test_layer_bridge_carries_vector_scales_and_bias_corr(rng):
    """from_jax_graph on a JAX layer graph calibrated per channel and
    bias-corrected: a vector a_scale arrives as an f32 numpy vector (a scalar
    one as a Python float), act_folded and bias_corr come across, a None
    part stays None."""
    from mask_yolo_tpu import quant as jquant

    def layer(name, a_scale, folded, corr, quantize=True):
        l = jquant.Layer(name, "conv", rng.randn(1, 1, 4, 6).astype(np.float32),
                         rng.randn(6).astype(np.float32), (1, 1), "relu", quantize=quantize)
        l.a_scale, l.act_folded, l.bias_corr = a_scale, folded, corr
        if quantize:
            jquant._quantize_layer_kernel(l, np.asarray(l.kernel))
        return l

    vec = rng.uniform(0.01, 0.1, 4).astype(np.float32)
    corr = jnp.asarray(rng.randn(6).astype(np.float32))
    graph = {"trunk": None,
             "mask": [layer("a", vec, True, corr), layer("b", 0.25, False, None),
                      layer("c", vec.astype(np.float64), False, None, quantize=False)]}
    out = weights.from_jax_graph(graph)
    assert out["trunk"] is None
    a, b, c = out["mask"]
    assert isinstance(a.a_scale, np.ndarray) and a.a_scale.dtype == np.float32
    np.testing.assert_array_equal(a.a_scale, vec)
    assert a.act_folded is True and isinstance(a.bias_corr, np.ndarray)
    np.testing.assert_array_equal(a.bias_corr, np.asarray(corr))
    np.testing.assert_array_equal(a.w_q, np.asarray(graph["mask"][0].w_q))
    assert isinstance(b.a_scale, float) and b.a_scale == 0.25
    assert b.act_folded is False and b.bias_corr is None
    assert c.a_scale.dtype == np.float32 and c.w_q is None and not c.quantize


def test_fpn_tree_round_trips_through_the_bridge(tiny_config, rng):
    """The ResNet-50 + FPN network's flax tree (its structure from
    `jax.eval_shape` of flax's init, random leaves) maps onto every key of
    the port's FPN network and back unchanged: no flax leaf and no torch key
    is left over in either direction."""
    cfg = tiny_config
    kw = dict(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
              top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
              mask_pool_size=cfg.MASK_POOL_SIZE, backbone="resnet50_fpn")
    shapes = jax.eval_shape(lambda: JaxNet(image_hw=(64, 64), **kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *cfg.IMAGE_SHAPE)), jnp.zeros((1, 4, 4)),
        train=False))
    tree = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32),
                                  jax.tree_util.tree_map(lambda s: s, shapes))
    tree = {k: dict(v) for k, v in tree.items()}
    net = MaskYoloNet(image_hw=(64, 64), **kw)
    state = weights.from_jax_variables(tree, net.state_dict().keys())
    net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    assert len(state) == _n_leaves(tree) + _n_leaves(tree["batch_stats"]) // 2
    block = net.backbone.c3_block0
    assert block.proj is not None and net.backbone.c3_block1.proj is None
    assert net.backbone.c2_block0.proj is not None      # 64 -> 256 at stride 1
    np.testing.assert_array_equal(
        block.conv1.weight.detach().numpy(),
        tree["params"]["backbone"]["c3_block0"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    back = weights.to_jax_variables(net.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    want = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=jax.tree_util.keystr(path))
