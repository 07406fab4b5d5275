"""The port's training path vs the JAX package's at TinyConfig size, f32: the
training forward and its gradients, BatchNorm statistics after a step, the
optimizer chain, a 3-step epoch, and the port's own checkpoints and
`MaskYOLO.train` surface.

Weights come from flax `MaskYoloNet.init` (mask_out scaled 8×, so the masks
spread) and reach the port through `weights.from_jax_variables`; gradients
go back through `to_jax_variables` (the deconv kernel flipped). Batches carry
the Shapes dataset's ground truth at 64² (seed 2: the first batch has
positive mask proposals at these weights) on seeded uniform-noise images.

Why noise images, and why the gradient limits depend on TRAIN_BN. Shapes
images are mostly flat background, so a stem channel's batch variance is
~1/200 of its mean square; XLA's f32 reductions on the CPU then get the
variance 0.7 % wrong (torch's, summed pairwise, are within 1e-5 of float64).
And with BatchNorm on batch statistics over 8 samples (the YOLO head at 2×2,
batch 2), the gradient is ill-conditioned: perturbing the port's weights by
a relative 1e-7 moves its own gradients by a median 0.9 % of each leaf's max
(cosine 0.99996), as far as they are from JAX's. So:
  * TRAIN_BN off (BatchNorm on running statistics): loss within rel 1e-5,
    each gradient leaf within 1e-4 of that leaf's max |JAX gradient| (+1e-7)
    (measured: 3.1e-6);
  * TRAIN_BN on: loss within rel 1e-4 and the whole gradient at cosine
    >= 0.9995 to JAX's; BatchNorm statistics within 1e-3 of each leaf's max
    (measured 1.7e-4; the unbiased-variance fault of nn.BatchNorm2d is 14 %
    of the head's variance increments). Against a float64 run of the port's
    forward, the port's f32 statistics are within 4.4e-5 of each leaf's max
    and JAX's within 2.0e-4, both worst at the YOLO head's 8-sample layers,
    so rel 1e-5 on the whole network is below f32's own noise. The
    BatchNorm layer alone is held to rel 1e-5 in
    test_batchnorm_layer_matches_flax.
Parameters are within 1e-6 of optax after 3 updates on identical gradients.

bf16 (COMPUTE_DTYPE "bfloat16" on f32 master weights), BatchNorm on running
statistics: the loss agrees with JAX's bf16 loss to rel 1e-4 (measured
1e-7), but a bf16 gradient is noisy in itself: JAX's own bf16 gradient is at
cosine 0.9991 to JAX's f32 gradient, with single leaves off by half their
max (one bf16 rounding that lands on the other side of a relu6 bound or a
0.5 ULP tie flips a whole activation's gradient). The port's bf16 gradient
is as close to JAX's bf16 one as that allows: whole-gradient cosine >= 0.998
(measured 0.9989), every leaf at cosine >= 0.9 (measured min 0.92), and no
farther from JAX's bf16 gradient than 1.5 x the distance between JAX's own
bf16 and f32 gradients.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import TinyConfig
from mask_yolo_tpu import pipelines as jpipelines
from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet
from mask_yolo_tpu.train import state as jstate
from mask_yolo_tpu.train import trainer as jtrainer
from mask_yolo_tpu_torch import MaskYOLO, pipelines, weights
from mask_yolo_tpu_torch.config import Config
from mask_yolo_tpu_torch.data.pipeline import BatchGenerator, preload_dataset
from mask_yolo_tpu_torch.data.shapes import ShapesDataset
from mask_yolo_tpu_torch.train import state, trainer

torch.set_num_threads(2)


class ShapesTiny(TinyConfig):
    NUM_CLASSES = 4
    LABELS = ["background", "square", "circle", "triangle"]
    MINI_MASK_SHAPE = (16, 16)


class MiniTopTiny(ShapesTiny):
    USE_MINI_MASK = True
    MASK_TRAIN_TOP_ROIS = 4


def frozen_bn(cls):
    return type("FrozenBN" + cls.__name__, (cls,), {"TRAIN_BN": False})


def port_config(jax_config, **over):
    values = {k: getattr(jax_config, k) for k in dir(jax_config) if k.isupper()}
    values.update(over)
    return type("Port" + type(jax_config).__name__, (Config,), values)()


def shapes(count, seed=2):
    ds = ShapesDataset()
    ds.load_shapes(count, 64, 64, seed=seed)
    ds.prepare()
    return ds


@pytest.fixture(scope="module")
def variables():
    cfg = ShapesTiny()
    net = JaxNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                 top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=cfg.MASK_POOL_SIZE)
    v = net.init(jax.random.PRNGKey(1), jnp.zeros((2, *cfg.IMAGE_SHAPE)),
                 jnp.zeros((2, 8, 4)), train=False)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    v["params"]["mask"]["mask_out"]["kernel"] *= 8.0
    return net, v


def port_model(cfg, v, mode="training", **kw):
    model = MaskYOLO(mode, cfg, seed=0, device="cpu", **kw)
    model.load_jax_variables(v)
    return model


def batches(cfg, count=2, mode="training"):
    """Shapes ground truth on seeded uniform-noise images."""
    data = preload_dataset(shapes(count), cfg)
    noise = np.random.RandomState(0).rand(*data["images"].shape)
    data["images"] = (noise * 255).astype(np.uint8)
    return BatchGenerator(data, cfg, mode=mode, shuffle=False)


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def grads_as_flax(keys, grads):
    return weights.to_jax_variables({k: g.detach() for k, g in zip(keys, grads)})["params"]


def assert_leaves_close(got, want, rel, what):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got_flat) == len(want_leaves), what
    for path, w in want_leaves:
        g = np.asarray(got_flat[path])
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max() + 1e-7,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("cfg_cls,mode", [
    (frozen_bn(ShapesTiny), "training"),    # MASK_TRAIN_TOP_ROIS 0, full-size GT masks
    (frozen_bn(MiniTopTiny), "training"),   # MASK_TRAIN_TOP_ROIS 4, mini-masks
    (frozen_bn(ShapesTiny), "yolo"),        # yolo_only_loss
], ids=["top0_full_masks", "top4_mini_masks", "yolo_only"])
def test_loss_and_gradients_match_jax(variables, cfg_cls, mode):
    net, v = variables
    jcfg = cfg_cls()
    cfg = port_config(jcfg)
    batch = batches(cfg, mode=mode)[0]
    jloss_fn = jpipelines.training_loss if mode == "training" else jpipelines.yolo_only_loss

    def jloss(params):
        return jloss_fn(net, {"params": params, "batch_stats": v["batch_stats"]},
                        {k: jnp.asarray(x) for k, x in batch.items()}, jcfg, seen=0.0,
                        train=True)

    (want, (jmetrics, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    model = port_model(cfg, v)
    loss_fn = pipelines.training_loss if mode == "training" else pipelines.yolo_only_loss
    loss, metrics = loss_fn(model.net, tensors(batch), cfg, 0.0, train=True)
    params = dict(model.net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = grads_as_flax(params, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(params.values(), grads)])
    if mode == "training":
        assert metrics["myolo_mask_loss"].item() > 0      # the mask branch is exercised
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k, w in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(w), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert_leaves_close(grads, jgrads, 1e-4, "grad")


def test_bf16_step_matches_jax_on_f32_masters(variables):
    """One bf16 training forward and backward (see the module docstring for
    the limits): f32 masters get f32 gradients, the loss and the gradients
    agree with the JAX package's bf16 network on the same f32 parameters,
    and one optimizer step moves the masters and keeps them f32."""
    _, v = variables
    jcfg = type("Bf16", (frozen_bn(MiniTopTiny),), {"COMPUTE_DTYPE": "bfloat16"})()
    cfg = port_config(jcfg)
    batch = batches(cfg)[0]
    jgrads = {}
    for dtype in ("bfloat16", "float32"):
        net = JaxNet(num_classes=jcfg.NUM_CLASSES, n_box=jcfg.N_BOX,
                     top_feature_map_depth=jcfg.TOP_FEATURE_MAP_DEPTH,
                     mask_pool_size=jcfg.MASK_POOL_SIZE, compute_dtype=dtype)

        def jloss(params, net=net):
            return jpipelines.training_loss(
                net, {"params": params, "batch_stats": v["batch_stats"]},
                {k: jnp.asarray(x) for k, x in batch.items()}, jcfg, seen=0.0, train=True)

        (jl, _), jgrads[dtype] = jax.value_and_grad(jloss, has_aux=True)(v["params"])
        if dtype == "bfloat16":
            want = float(jl)
    model = port_model(cfg, v)
    params = dict(model.net.named_parameters())
    assert {p.dtype for p in params.values()} == {torch.float32}
    assert model.net.mask.mask_conv1.compute_dtype == torch.bfloat16
    loss, metrics = pipelines.training_loss(model.net, tensors(batch), cfg, 0.0, train=True)
    assert metrics["myolo_mask_loss"].item() > 0 and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), want, rtol=1e-4)
    raw = torch.autograd.grad(loss, list(params.values()))
    assert {g.dtype for g in raw} == {torch.float32}
    grads = grads_as_flax(params, raw)

    def flat(tree):
        return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])

    def cosine(a, b):
        return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))

    g, j16, j32 = flat(grads), flat(jgrads["bfloat16"]), flat(jgrads["float32"])
    assert cosine(g, j16) >= 0.998, cosine(g, j16)
    assert np.linalg.norm(g - j16) <= 1.5 * np.linalg.norm(j16 - j32)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, w in jax.tree_util.tree_leaves_with_path(jgrads["bfloat16"]):
        leaf = cosine(np.ravel(got_leaves[path]), np.ravel(w))
        assert leaf >= 0.9, (jax.tree_util.keystr(path), leaf)

    before = {k: p.detach().clone() for k, p in params.items()}
    tx = state.make_optimizer(1e-3, cfg, params)
    st = state.create_train_state(model.net, tx)
    st, _ = trainer.make_train_step(cfg, tx)(st, tensors(batch))
    assert all(p.dtype == torch.float32 for p in st.params.values())
    assert all(m.dtype == torch.float32 for m in st.opt_state["mu"].values())
    moved = [k for k, p in st.params.items() if not torch.equal(p, before[k])]
    assert len(moved) == len(before)
    # an update far below a bf16 ULP of the weight still lands in the master
    k = "backbone.conv1.conv.weight"
    step = (st.params[k] - before[k]).abs().max().item()
    assert 0 < step <= 1.01e-3 and not torch.equal(st.params[k].bfloat16(), st.params[k])


def test_bf16_train_checkpoints_f32_masters_and_resumes_exactly(tmp_path):
    """MaskYOLO.train in bf16: checkpoints hold the f32 masters, the host
    copy reads them, and resume_from restores params, statistics and
    moments exactly."""
    cfg = port_config(ShapesTiny(), COMPUTE_DTYPE="bfloat16", STEPS_PER_EPOCH=2,
                      VALIDATION_STEPS=1)
    train_ds, val_ds = shapes(4), shapes(2, seed=3)
    kept = {}

    def keep(epoch, metrics, val_loss, st):
        kept[epoch] = ({k: p.detach().clone() for k, p in st.params.items()},
                       {k: m.clone() for k, m in st.opt_state["mu"].items()}, st.step)

    model = MaskYOLO("training", cfg, model_dir=str(tmp_path), seed=0, device="cpu")
    model.train(train_ds, val_ds, 1e-3, epochs=2, verbose=False, custom_callbacks=[keep])
    ckpts = sorted(p for p in os.listdir(tmp_path) if p.startswith("saved_model_"))
    first = state.load_checkpoint(str(tmp_path / ckpts[0]))
    assert {p.dtype for p in first["params"].values()} == {torch.float32}
    for k, p in kept[0][0].items():
        assert torch.equal(first["params"][k], p), k
    np.testing.assert_array_equal(model._host_state["feature_map.weight"],
                                  kept[1][0]["feature_map.weight"].numpy())

    fresh = MaskYOLO("training", cfg, seed=5, device="cpu")
    tx = state.make_optimizer(1e-3, cfg, dict(fresh.net.named_parameters()))
    st, epoch = state.resume_train_state(str(tmp_path / ckpts[0]),
                                         state.create_train_state(fresh.net, tx), tx)
    assert epoch == 1 and st.step == kept[0][2]
    for k, p in kept[0][0].items():
        assert torch.equal(st.params[k], p), k
    for k, m in kept[0][1].items():
        assert torch.equal(st.opt_state["mu"][k], m), k
    # an inference model casts the masters to its compute dtype on load
    infer = MaskYOLO("inference", cfg, device="cpu")
    infer.load_weights(str(tmp_path / ckpts[1]))
    w = infer.net.feature_map.weight
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, kept[1][0]["feature_map.weight"].bfloat16())


@pytest.mark.parametrize("n", [8, 128])
def test_batchnorm_layer_matches_flax(rng, n):
    """One BatchNorm in train mode on the same input: output and updated
    statistics within rel 1e-5 of flax. At n = 8 samples per channel (the
    YOLO head at TinyConfig) nn.BatchNorm2d's unbiased running-variance
    update is 14 % too large."""
    import flax.linen as fnn

    from mask_yolo_tpu_torch.models.layers import BatchNorm

    b, side = (2, 2) if n == 8 else (2, 8)
    x = (rng.randn(b, side, side, 16) * 2 + 1).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.normal(0, 0.3, 16)
    mean, var = rng.normal(0, 0.2, 16), rng.uniform(0.5, 1.5, 16)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), v)
    want, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    layer = BatchNorm(16).train()
    with torch.no_grad():
        for name, a in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(layer, name).copy_(torch.tensor(a))
    got = layer(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for mine, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(layer, mine).numpy(),
                                   np.asarray(upd["batch_stats"][theirs]), rtol=1e-5)


@pytest.fixture(scope="module")
def train_bn_step(variables):
    """One training step's forward and gradients with TRAIN_BN (as
    ShapesConfig trains), MASK_TRAIN_TOP_ROIS 4 and mini-masks, in both
    packages: JAX's (loss, batch_stats, grads) and the port's (loss,
    batch_stats as flax leaves, grads as flax leaves)."""
    net, v = variables
    jcfg = MiniTopTiny()
    cfg = port_config(jcfg)
    batch = batches(cfg)[0]

    def jloss(params):
        return jpipelines.training_loss(
            net, {"params": params, "batch_stats": v["batch_stats"]},
            {k: jnp.asarray(x) for k, x in batch.items()}, jcfg, seen=0.0, train=True,
            mutable_stats=True)

    (want, (_, updates)), jgrads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    model = port_model(cfg, v)
    loss, metrics = pipelines.training_loss(model.net, tensors(batch), cfg, 0.0, train=True)
    assert metrics["myolo_mask_loss"].item() > 0
    params = dict(model.net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    stats = weights.to_jax_variables(
        {k: b for k, b in model.net.named_buffers() if "running" in k})["batch_stats"]
    return ((float(want), jax.device_get(updates["batch_stats"]), jax.device_get(jgrads)),
            (loss.item(), stats, grads_as_flax(params, grads)))


def test_train_bn_loss_and_gradient_match_jax(train_bn_step):
    """With BatchNorm on batch statistics: loss within rel 1e-4, the whole
    gradient at cosine >= 0.9995 to JAX's (see the module docstring)."""
    (want, _, jgrads), (loss, _, grads) = train_bn_step
    np.testing.assert_allclose(loss, want, rtol=1e-4)
    flat = [np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(t)])
            for t in (grads, jgrads)]
    cosine = flat[0] @ flat[1] / np.linalg.norm(flat[0]) / np.linalg.norm(flat[1])
    assert cosine >= 0.9995, cosine


def test_batchnorm_statistics_after_one_step_match_flax(train_bn_step):
    """Every batch_stats leaf after one training step's forward, within 1e-3
    of its max (see the module docstring). flax updates running variances
    with the biased batch variance; at TinyConfig the YOLO head sees 8
    samples per channel, where the unbiased n/(n-1) update of
    nn.BatchNorm2d is 14 % off."""
    (_, want, _), (_, got, _) = train_bn_step
    assert_leaves_close(got, want, 1e-3, "batch_stats")


# a few layers of each top-level module, with every kind of leaf
OPT_LAYERS = ("backbone.conv1.", "backbone.block1.", "feature_map.", "yolo.block14.",
              "yolo.conv_23.", "mask.mask_conv1.", "mask.mask_bn1.", "mask.mask_deconv.")
OPT_CASES = {
    "clip_and_inf": dict(cfg={}, regex=".*", frozen=()),
    "regex_freeze": dict(cfg={}, regex=r"mask.*|feature_map", frozen=()),
    "yolo_trainable_false": dict(cfg={}, regex=".*", frozen=("backbone", "yolo")),
    "warmup": dict(cfg={"LR_WARMUP_STEPS": 2}, regex=".*", frozen=()),
    "cosine": dict(cfg={"LR_SCHEDULE": "cosine", "LR_WARMUP_STEPS": 1,
                        "LR_FINAL_FRACTION": 0.1}, regex=".*", frozen=()),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(variables, rng, case):
    """Three updates on identical gradients (N(0, 1): the global norm is far
    above GRADIENT_CLIP_NORM = 5, so the clip is active; step 2 carries an
    inf and a nan)."""
    _, v = variables
    spec = OPT_CASES[case]
    jcfg = type("OptTiny", (ShapesTiny,), spec["cfg"])()
    cfg = port_config(jcfg)
    model = port_model(cfg, v)
    params = {k: p for k, p in model.net.named_parameters() if k.startswith(OPT_LAYERS)}
    before = {k: p.detach().clone() for k, p in params.items()}
    tx = state.make_optimizer(1e-2, cfg, params, layer_regex=spec["regex"],
                              frozen_prefixes=spec["frozen"], total_steps=3)
    opt_state = tx.init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, weights.to_jax_variables(before)["params"])
    jtx = jstate.make_optimizer(1e-2, jcfg, params=jparams, layer_regex=spec["regex"],
                                frozen_prefixes=spec["frozen"], total_steps=3)
    jopt = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)
    for step in range(3):
        grads = {k: rng.randn(*p.shape).astype(np.float32) for k, p in params.items()}
        if step == 1:
            first = next(iter(grads))
            grads[first].flat[0] = np.inf
            grads[first].flat[1] = np.nan
        tx.apply(params, {k: torch.from_numpy(g) for k, g in grads.items()}, opt_state)
        jgrads = weights.to_jax_variables(grads)["params"]
        upd, jopt = jupdate(jgrads, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
    got = weights.to_jax_variables({k: p.detach() for k, p in params.items()})["params"]
    for path, w in jax.tree_util.tree_leaves_with_path(jax.device_get(jparams)):
        g = dict(jax.tree_util.tree_leaves_with_path(got))[path]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    trainable = set(tx.keys)
    assert set(opt_state["mu"]) == trainable and opt_state["count"] == 3
    frozen = [k for k in params if k not in trainable]
    assert bool(frozen) == (case in ("regex_freeze", "yolo_trainable_false"))
    for k in frozen:
        assert torch.equal(params[k], before[k]), k


def test_run_epoch_matches_jax_trainer(variables):
    """Three steps of run_epoch (the port's prefetcher passes CPU batches
    through) against the JAX trainer on the same batches, with BatchNorm on
    running statistics (with TRAIN_BN the gradients are too ill-conditioned
    at TinyConfig to follow for steps: see the module docstring)."""
    net, v = variables
    jcfg = frozen_bn(ShapesTiny)()
    cfg = port_config(jcfg)
    gen = batches(cfg, count=6)

    jlosses = []
    tx = jstate.make_optimizer(1e-3, jcfg)
    jstep = jtrainer.make_train_step(net, jcfg, tx)

    def jrecord(st, batch):
        st, m = jstep(st, batch)
        jlosses.append(float(m["loss"]))
        return st, m

    jst = jstate.create_train_state(jax.tree_util.tree_map(jnp.array, v["params"]),
                                    jax.tree_util.tree_map(jnp.array, v["batch_stats"]), tx)
    jtrainer.run_epoch(jrecord, jst, gen, verbose=False, prefetch=0)

    losses = []
    model = port_model(cfg, v)
    ptx = state.make_optimizer(1e-3, cfg, dict(model.net.named_parameters()))
    step = trainer.make_train_step(cfg, ptx)

    def record(st, batch):
        st, m = step(st, batch)
        losses.append(m["loss"].item())
        return st, m

    st, last = trainer.run_epoch(record, state.create_train_state(model.net, ptx), gen,
                                 verbose=False)
    assert st.step == 3 and len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert last["loss"] == losses[-1]


def test_checkpoint_save_and_resume_restore_everything(variables, tmp_path):
    _, v = variables
    cfg = port_config(ShapesTiny())
    gen = batches(cfg)
    model = port_model(cfg, v)
    tx = state.make_optimizer(1e-3, cfg, dict(model.net.named_parameters()))
    st = state.create_train_state(model.net, tx)
    step = trainer.make_train_step(cfg, tx)
    for _ in range(2):
        st, _ = step(st, tensors(gen[0]))
    path = str(tmp_path / "ckpt.pt")
    state.save_checkpoint(path, st, epoch=4)

    fresh = MaskYOLO("training", cfg, seed=3, device="cpu")
    tx2 = state.make_optimizer(1e-3, cfg, dict(fresh.net.named_parameters()))
    st2, epoch = state.resume_train_state(path, state.create_train_state(fresh.net, tx2), tx2)
    assert epoch == 4 and st2.step == 2 and st2.opt_state["count"] == 2
    for name in ("params", "batch_stats"):
        a, b = getattr(st, name), getattr(st2, name)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    for m in ("mu", "nu"):
        for k in tx.keys:
            assert torch.equal(st.opt_state[m][k], st2.opt_state[m][k])

    # another schedule kind: moments reset with a warning, the rest restores
    cos = port_config(ShapesTiny(), LR_SCHEDULE="cosine")
    tx3 = state.make_optimizer(1e-3, cos, dict(fresh.net.named_parameters()), total_steps=5)
    with pytest.warns(UserWarning, match="RESET"):
        st3, epoch = state.resume_train_state(path, state.create_train_state(fresh.net, tx3), tx3)
    assert epoch == 4 and st3.step == 2 and st3.opt_state["count"] == 0


def test_maskyolo_train_checkpoints_history_and_resume(tmp_path):
    cfg = port_config(ShapesTiny(), STEPS_PER_EPOCH=2, VALIDATION_STEPS=1, MAX_CHECKPOINTS=2)
    train_ds, val_ds = shapes(6), shapes(2, seed=3)
    seen = []
    model = MaskYOLO("training", cfg, model_dir=str(tmp_path), seed=0, device="cpu")
    st = model.train(train_ds, val_ds, 1e-3, epochs=2, verbose=False,
                     custom_callbacks=[lambda e, m, vl, s: seen.append((e, vl, s.step))])
    assert model.epoch == 2 and st.step == 4 and [s[0] for s in seen] == [0, 1]
    assert all(np.isfinite(s[1]) for s in seen) and [s[2] for s in seen] == [2, 4]
    assert json.load(open(tmp_path / "config.json"))["NUM_CLASSES"] == 4
    ckpts = sorted(p for p in os.listdir(tmp_path) if p.startswith("saved_model_"))
    assert [c[-8:] for c in ckpts] == ["e0001.pt", "e0002.pt"]
    assert not model.net.training           # back to inference BatchNorm

    resumed = MaskYOLO("training", cfg, model_dir=str(tmp_path), seed=1, device="cpu")
    st = resumed.train(train_ds, val_ds, 1e-3, epochs=3, verbose=False,
                       resume_from=str(tmp_path / ckpts[-1]))
    assert resumed.epoch == 3 and st.step == 6
    history = [json.loads(line) for line in open(tmp_path / "history.jsonl")]
    assert [h["epoch"] for h in history] == [1, 2, 3]
    ckpts = sorted(p for p in os.listdir(tmp_path) if p.startswith("saved_model_"))
    assert [c[-8:] for c in ckpts] == ["e0002.pt", "e0003.pt"]   # MAX_CHECKPOINTS

    stopped = MaskYOLO("yolo", cfg, model_dir=str(tmp_path / "yolo"), seed=0, device="cpu")
    stopped.train(train_ds, val_ds, 1e-3, epochs=5, verbose=False, stop_after_epoch=1)
    assert stopped.epoch == 1


def test_yolo_trainable_false_freezes_backbone_and_yolo_head(tmp_path):
    """yolo_trainable=False freezes the image→YOLO-output path; the mask
    head trains and the frozen layers' BatchNorm statistics still move."""
    cfg = port_config(ShapesTiny(), STEPS_PER_EPOCH=2, VALIDATION_STEPS=1)
    model = MaskYOLO("training", cfg, model_dir=str(tmp_path), yolo_trainable=False,
                     device="cpu")
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    model.train(shapes(4), shapes(2, seed=3), 1e-3, epochs=1, verbose=False)
    after = model.net.state_dict()
    for k, v in after.items():
        top = k.split(".")[0]
        if top in ("backbone", "yolo") and not k.endswith(("running_mean", "running_var",
                                                          "num_batches_tracked")):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(after["mask.mask_conv1.weight"], before["mask.mask_conv1.weight"])
    assert not torch.equal(after["backbone.conv1.bn.running_mean"],
                           before["backbone.conv1.bn.running_mean"])


def test_save_and_load_weights_by_name_and_exclude(tmp_path):
    cfg = port_config(ShapesTiny())
    a = MaskYOLO("training", cfg, seed=0, device="cpu")
    b = MaskYOLO("training", cfg, seed=1, device="cpu")
    path = str(tmp_path / "w.pt")
    a.save_weights(path)
    b_mask = b.net.mask.mask_conv1.weight.detach().clone()
    b.load_weights(path, by_name=True, exclude=["mask"])
    assert torch.equal(b.net.backbone.conv1.conv.weight, a.net.backbone.conv1.conv.weight)
    assert torch.equal(b.net.mask.mask_conv1.weight, b_mask)
    np.testing.assert_array_equal(b._host_state["backbone.conv1.conv.weight"],
                                  a.net.backbone.conv1.conv.weight.detach().numpy())
    b.load_weights(path)
    assert torch.equal(b.net.mask.mask_conv1.weight, a.net.mask.mask_conv1.weight)


def test_training_weights_follow_flax_default_init():
    """Training mode draws LeCun-normal kernels truncated at 2 std, zero
    biases and identity BatchNorm; inference mode keeps He-normal."""
    cfg = port_config(ShapesTiny())
    net = MaskYOLO("training", cfg, seed=0, device="cpu").net
    w = net.yolo.block7.conv_pw.weight.detach()             # 1×1, fan_in 512
    std = np.sqrt(1.0 / 512) / 0.87962566103423978
    assert abs(w.std().item() - std * 0.8796) < 0.05 * std
    assert w.abs().max().item() <= 2 * std
    assert not net.feature_map.bias.any()
    assert torch.equal(net.backbone.conv1.bn.running_var, torch.ones(32))
    inference = MaskYOLO("inference", cfg, seed=0, device="cpu").net
    assert inference.yolo.block7.conv_pw.weight.std().item() > 1.3 * w.std().item()


@pytest.mark.parametrize("what", ["bf16", "augmentation", "data_workers", "profile_dir",
                                  "resnet50_fpn", "keras_h5", "data_parallel"])
def test_held_out_options_raise_naming_their_roadmap_item(tmp_path, what):
    """What is still held out raises, naming its ROADMAP item; bf16 training,
    augmentation, data workers and profiler traces are ported and run."""
    cfg = port_config(ShapesTiny())
    ds = shapes(2)

    def train(**over):
        MaskYOLO("training", port_config(ShapesTiny(), **over),
                 model_dir=str(tmp_path), device="cpu").train(ds, ds, 1e-3, epochs=1, verbose=False)

    cases = {
        "bf16": lambda: MaskYOLO("yolo", port_config(ShapesTiny(), COMPUTE_DTYPE="bfloat16"),
                                 device="cpu"),
        "augmentation": lambda: MaskYOLO("training", cfg, model_dir=str(tmp_path),
                                         device="cpu").train(
            ds, ds, 1e-3, epochs=1, augmentation=lambda im, m: (im, m)),
        "data_workers": lambda: train(DATA_WORKERS=2),
        "profile_dir": lambda: MaskYOLO("training", cfg, model_dir=str(tmp_path),
                                        device="cpu").train(
            ds, ds, 1e-3, epochs=1, verbose=False, profile_dir=str(tmp_path)),
        "resnet50_fpn": lambda: MaskYOLO("training",
                                         port_config(ShapesTiny(), BACKBONE="resnet50_fpn"),
                                         device="cpu"),
        "keras_h5": lambda: MaskYOLO("yolo", cfg, yolo_pretrain_dir="pretrained.h5",
                                     device="cpu"),
        "data_parallel": lambda: train(DATA_PARALLEL=2),
    }
    if what in ("bf16", "augmentation", "data_workers", "profile_dir"):
        cases[what]()   # (a one-step epoch ends before the profiler's window opens)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cases[what]()
