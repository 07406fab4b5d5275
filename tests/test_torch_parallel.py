"""The port's parallel package (mask_yolo_tpu_torch/parallel) on the CPU over
gloo, against the JAX package and against the port in one process.

The rank workers live in this file's `__main__` block, run as
`python tests/test_torch_parallel.py <case> <workdir> ...` with the MYOLO_*
triplet set: they import torch and the port, never JAX (nor conftest, which
imports it). The parent writes their weights (a flax init carried across by
`weights.from_jax_variables`) and inputs to the work directory as numpy and
compares what rank 0 writes back. Every subprocess has a timeout, and so does
every collective (`distributed.initialize`'s), so a rank that dies fails the
test instead of hanging the suite.

Tolerances. Against JAX's single-device step on the same global batch, the
ones of tests/test_multichip.py: loss rtol 1e-4, parameters rtol 2e-3 and
atol 2.1e-3 (one Adam step; a sign flip of a ~0 gradient moves a weight by
2·lr). One Adam step hardly sees the gradient's scale, so the gradients the
update is handed are held to the port's own single-process step as well: the
whole gradient at cosine >= 0.9999 and each leaf within 5 % of its max
(measured: cosine 0.999997, worst leaf 2.2 %; with BatchNorm on 8-sample
batch statistics the TinyConfig gradient is ill-conditioned,
tests/test_torch_train.py), the loss within rel 1e-5 (measured 4.9e-6) and
the BatchNorm running statistics within 1e-5 of each leaf's max: both steps
sum in f32, in another order. Detection on the mesh equals the
single-process port bit for bit: each image is detected on its own.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mask_yolo_tpu_torch import MaskYOLO, evaluate_dataset, weights  # noqa: E402
from mask_yolo_tpu_torch.config import Config  # noqa: E402
from mask_yolo_tpu_torch.data.shapes import ShapesDataset  # noqa: E402
from mask_yolo_tpu_torch.parallel import distributed  # noqa: E402
from mask_yolo_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mask_yolo_tpu_torch.parallel.inference import ShardedDetector  # noqa: E402
from mask_yolo_tpu_torch.train import state as state_lib  # noqa: E402
from mask_yolo_tpu_torch.train import trainer  # noqa: E402

# TinyConfig's values (tests/conftest.py), given here so that the workers
# need no conftest; the parent checks they are the same
TINY = dict(NAME="tiny", LABELS=["background", "a", "b"], NUM_CLASSES=3,
            IMAGE_SHAPE=[64, 64, 3], IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=64, GRID_H=2, GRID_W=2,
            N_BOX=2, ANCHORS=[0.6, 0.7, 1.2, 1.1], TRUE_BOX_BUFFER=4, MAX_GT_INSTANCES=4,
            TRAIN_ROIS_PER_IMAGE=8, MASK_POOL_SIZE=4, MASK_SHAPE=[8, 8],
            TOP_FEATURE_MAP_DEPTH=16, BATCH_SIZE=2, TRAIN_BN=True, DETECTION_MAX_INSTANCES=4)
GLOBAL_BATCH = 8
LR = 1e-3
TIMEOUT_S = 150
WORKER = os.path.abspath(__file__)


def port_config(**over):
    return type("PortTiny", (Config,), {**TINY, **over})()


def shapes(count, seed):
    ds = ShapesDataset()
    ds.load_shapes(count, 64, 64, seed=seed)
    ds.prepare()
    return ds


def train_batch():
    """test_multichip.py's global batch of 8: noise images, one box each."""
    rng = np.random.RandomState(3)
    g = TINY["MAX_GT_INSTANCES"]
    batch = {
        "image": rng.rand(GLOBAL_BATCH, 64, 64, 3).astype(np.float32),
        "yolo_target": np.zeros((GLOBAL_BATCH, 2, 2, 2, 8), np.float32),
        "true_boxes": np.zeros((GLOBAL_BATCH, 1, 1, 1, TINY["TRUE_BOX_BUFFER"], 4), np.float32),
        "gt_class_ids": np.zeros((GLOBAL_BATCH, g), np.int32),
        "gt_boxes": np.zeros((GLOBAL_BATCH, g, 4), np.float32),
        "gt_masks": np.zeros((GLOBAL_BATCH, 64, 64, g), bool),
    }
    for b in range(GLOBAL_BATCH):
        batch["yolo_target"][b, 1, 0, 0] = [0.5, 1.5, 0.8, 0.8, 1.0, 0.0, 1.0, 0.0]
        batch["true_boxes"][b, 0, 0, 0, 0] = [0.5, 1.5, 0.8, 0.8]
        batch["gt_class_ids"][b, 0] = 1
        batch["gt_boxes"][b, 0] = [4, 36, 28, 60]
        batch["gt_masks"][b, 40:56, 8:24, 0] = True
    return batch


def port_model(mode, cfg, state_dict):
    model = MaskYOLO(mode, cfg, seed=0, device="cpu")
    model.load_jax_variables(weights.to_jax_variables(state_dict))
    return model


def recording(tx):
    """tx, with the gradients each update is handed kept in tx.seen."""
    apply = tx.apply

    def record(params, grads, opt_state):
        tx.seen = {k: None if g is None else g.detach().clone() for k, g in grads.items()}
        apply(params, grads, opt_state)

    tx.apply = record
    return tx


def port_step(cfg, state_dict, batch):
    """The port's training step in one process on the whole batch:
    (state, metrics, the gradients of the update)."""
    model = port_model("training", cfg, state_dict)
    tx = recording(state_lib.make_optimizer(LR, cfg, dict(model.net.named_parameters())))
    step = trainer.make_train_step(cfg, tx, "training")
    state = state_lib.create_train_state(model.net, tx)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state, metrics, tx.seen


def wide_shapes(net):
    return {k: list(p.shape) for k, p in net.named_parameters()
            if p.dim() == 4 and p.shape[0 if "deconv" not in k else 1] >= 128}


# ---------------------------------------------------------------------------
# rank workers (no JAX)
# ---------------------------------------------------------------------------


def worker_train(workdir, dp, mp, backbone="mobilenet", train_bn="1"):
    rank, world = distributed.initialize(device="cpu", timeout_s=TIMEOUT_S)
    assert world == dp * mp
    setup = np.load(os.path.join(workdir, "setup.npz"))
    state_dict = {k[3:]: setup[k] for k in setup.files if k.startswith("sd.")}
    batch = {k[6:]: setup[k] for k in setup.files if k.startswith("batch.")}
    cfg = port_config(DATA_PARALLEL=dp, MODEL_PARALLEL=mp, BATCH_SIZE=GLOBAL_BATCH // dp,
                      BACKBONE=backbone, TRAIN_BN=train_bn == "1")
    mesh = mesh_lib.build_mesh(cfg)
    model = port_model("training", cfg, state_dict)
    shardings = mesh_lib.place_network(model.net, mesh)
    before = wide_shapes(model.net)
    norms = [m for m in model.net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    grouped = sum(m.data_group is not None for m in norms)
    tx = recording(state_lib.make_optimizer(LR, cfg, dict(model.net.named_parameters())))
    tx.shard(shardings, mesh.model_group)
    step = trainer.make_train_step(cfg, tx, "training", mesh=mesh)
    state = state_lib.create_train_state(model.net, tx)
    rows = mesh_lib.batch_slice(GLOBAL_BATCH, mesh)
    state, metrics = step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
    after = wide_shapes(model.net)
    ckpt = os.path.join(workdir, "step.pt")
    state_lib.save_checkpoint(ckpt, state, epoch=1, mesh=mesh, shardings=shardings)
    # a parameter the loss does not read (the FPN network's neck) has none
    grads = mesh_lib.gather_tree({k: g for k, g in tx.seen.items() if g is not None},
                                 shardings, mesh)
    if rank == 0:
        np.savez(os.path.join(workdir, "grads.npz"), **{k: g.numpy() for k, g in grads.items()})
    # the detector on the same mesh (every rank of a model group passes the
    # same images; here all ranks do)
    det_cfg = port_config(OBJ_THRESHOLD=0.0, BACKBONE=backbone)
    det = ShardedDetector(port_model("inference", det_cfg, state_dict).net, det_cfg, mesh)
    held = {k: list(p.shape) for k, p in det.net.named_parameters()}
    out = det.local_results(det(setup["images"]))
    if rank == 0:
        np.savez(os.path.join(workdir, "detect.npz"), **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"loss": float(metrics["loss"]), "before": before, "after": after,
                   "dims": {k: v for k, v in shardings.items() if v is not None},
                   "detector": held, "batch_norms": [grouped, len(norms)]}, f)
    distributed.shutdown()


def worker_detect(workdir):
    rank, world = distributed.initialize(device="cpu", timeout_s=TIMEOUT_S)
    setup = np.load(os.path.join(workdir, "setup.npz"))
    state_dict = {k[3:]: setup[k] for k in setup.files if k.startswith("sd.")}
    cfg = port_config(OBJ_THRESHOLD=0.0)
    model = port_model("inference", cfg, state_dict)
    images = setup["images"]
    rows = mesh_lib.batch_slice(len(images), model.mesh)
    out, collectives = {}, []
    real = {name: getattr(torch.distributed, name) for name in ("all_reduce", "all_gather")}

    def counted(fn):
        def call(*args, **kwargs):
            collectives.append(1)
            return fn(*args, **kwargs)
        return call

    def detect():   # a DP detect runs no collective at all
        for name, fn in real.items():
            setattr(torch.distributed, name, counted(fn))
        try:
            return model.detect_batch(images[rows], mesh=True)
        finally:
            for name, fn in real.items():
                setattr(torch.distributed, name, fn)

    out.update({f"float.{k}": v.numpy()
                for k, v in mesh_lib.gather_batch(detect(), model.mesh).items()})
    result = evaluate_dataset(model, shapes(6, seed=5), cfg, batch_size=4, mesh=True)
    model.quantize(setup["calib"])
    out.update({f"int8.{k}": v.numpy()
                for k, v in mesh_lib.gather_batch(detect(), model.mesh).items()})
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    result.pop("per_image")
    result["collectives"] = len(collectives)
    with open(os.path.join(workdir, f"eval{rank}.json"), "w") as f:
        json.dump(result, f)
    distributed.shutdown()


def worker_fit(workdir):
    rank, world = distributed.initialize(device="cpu", timeout_s=TIMEOUT_S)
    cfg = port_config(DATA_PARALLEL=2, NUM_CLASSES=4, BATCH_SIZE=2,
                      LABELS=["background", "square", "circle", "triangle"])
    model = MaskYOLO("training", cfg, model_dir=os.path.join(workdir, "ckpt"), seed=0,
                     device="cpu")
    model.train(shapes(8, seed=2), shapes(4, seed=3), learning_rate=LR, epochs=1,
                verbose=False)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in model.net.state_dict().items()})
    distributed.shutdown()


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(case, n, workdir, *args):
    """Run `case` on n ranks; every rank must exit 0 within TIMEOUT_S."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MYOLO_COORDINATOR=f"localhost:{port}",
                   MYOLO_NUM_PROCESSES=str(n), MYOLO_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        log = open(os.path.join(workdir, f"{case}{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, case, str(workdir), *args],
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    try:
        for rank, (proc, log) in enumerate(procs):
            try:
                rc = proc.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append(rank)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = [open(os.path.join(workdir, f"{case}{r}.log")).read()[-3000:] for r in failed]
        pytest.fail(f"ranks {failed} of {case} failed:\n" + "\n---\n".join(logs))


@pytest.fixture(scope="module")
def jax_setup():
    import jax
    import jax.numpy as jnp

    from conftest import TinyConfig
    from mask_yolo_tpu.models.network import MaskYoloNet as JaxNet

    cfg = TinyConfig()
    assert all(getattr(cfg, k) == v for k, v in TINY.items())
    net = JaxNet(num_classes=cfg.NUM_CLASSES, n_box=cfg.N_BOX,
                 top_feature_map_depth=cfg.TOP_FEATURE_MAP_DEPTH,
                 mask_pool_size=cfg.MASK_POOL_SIZE)
    v = net.init(jax.random.PRNGKey(0), jnp.zeros((GLOBAL_BATCH, *cfg.IMAGE_SHAPE)),
                 jnp.zeros((GLOBAL_BATCH, 8, 4)), train=False)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    keys = MaskYOLO("training", port_config(), device="cpu").net.state_dict().keys()
    return cfg, net, v, weights.from_jax_variables(v, keys)


@pytest.fixture(scope="module")
def jax_step(jax_setup):
    """JAX's single-device training step on the global batch."""
    import jax
    import jax.numpy as jnp

    from mask_yolo_tpu.train import state as jstate
    from mask_yolo_tpu.train import trainer as jtrainer

    cfg, net, v, _ = jax_setup
    tx = jstate.make_optimizer(LR, cfg)
    step = jtrainer.make_train_step(net, cfg, tx, mode="training")
    fresh = lambda tree: jax.tree.map(jnp.array, tree)   # noqa: E731
    st = jstate.create_train_state(fresh(v["params"]), fresh(v["batch_stats"]), tx)
    st, metrics = step(st, {k: jnp.asarray(x) for k, x in train_batch().items()})
    return float(metrics["loss"]), jax.device_get(st.params)


def write_setup(workdir, state_dict, **arrays):
    np.savez(os.path.join(workdir, "setup.npz"),
             **{f"sd.{k}": v for k, v in state_dict.items()}, **arrays)


def assert_params_close(got_sd, want_params):
    """Every leaf at test_multichip.py's Adam-step tolerance."""
    import jax

    got = weights.to_jax_variables(got_sd)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(want_params))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w), rtol=2e-3,
                                   atol=2.1e-3, err_msg=str(path))


@pytest.mark.parametrize("dp,mp", [(2, 1), (2, 2)], ids=["dp2", "dp2xmp2"])
def test_train_step_on_mesh_matches_single_device(jax_setup, jax_step, tmp_path, dp, mp):
    """2 ranks (DP) and 4 ranks (dp 2 × mp 2): the step on the mesh equals
    JAX's single-device step on the global batch and the port's own, and
    under TP every wide conv (O >= 256) is held half per rank before and
    after the step; the chief's checkpoint holds the whole tree."""
    _, _, _, sd = jax_setup
    batch = train_batch()
    images = (np.random.RandomState(5).rand(4, 64, 64, 3) * 255).astype(np.uint8)
    write_setup(tmp_path, sd, images=images, **{f"batch.{k}": v for k, v in batch.items()})
    launch("train", dp * mp, tmp_path, str(dp), str(mp))
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(dp * mp)]
    ckpt = state_lib.load_checkpoint(str(tmp_path / "step.pt"))

    jax_loss, jax_params = jax_step
    np.testing.assert_allclose(ranks[0]["loss"], jax_loss, rtol=1e-4)
    assert_params_close({**{k: v.numpy() for k, v in ckpt["params"].items()},
                         **{k: v.numpy() for k, v in ckpt["batch_stats"].items()}}, jax_params)

    single, metrics, want_grads = port_step(port_config(), sd, batch)
    grads = np.load(tmp_path / "grads.npz")
    flat = lambda g: np.concatenate([np.ravel(g[k]) for k in sorted(want_grads)])  # noqa: E731
    a, b = flat(grads), flat({k: v.numpy() for k, v in want_grads.items()})
    cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    worst = max(float(np.abs(grads[k] - v.numpy()).max() / (np.abs(v.numpy()).max() + 1e-12))
                for k, v in want_grads.items())
    assert cos >= 0.9999 and worst <= 0.05, (cos, worst)
    assert all(abs(r["loss"] - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
               for r in ranks)
    for k, want in single.batch_stats.items():
        got, want = ckpt["batch_stats"][k].numpy(), want.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=k)
    full = {k: list(p.shape) for k, p in single.params.items()}
    assert {k: list(v.shape) for k, v in ckpt["params"].items()} == full
    assert {k: list(v.shape) for k, v in ckpt["opt_state"]["mu"].items()} == {
        k: full[k] for k in ckpt["opt_state"]["mu"]}
    for r in ranks:
        assert r["before"] == r["after"]
        for k, dim in r["dims"].items():
            if k in r["before"]:
                want = list(full[k])
                want[dim] //= mp
                assert r["before"][k] == want, k
    if mp > 1:
        wide = [k for k, s in full.items() if len(s) == 4
                and s[1 if "deconv" in k else 0] >= 256]
        assert wide and set(wide) <= set(ranks[0]["dims"])
        for k in wide:   # the detector's copy is split too
            assert ranks[0]["detector"][k] == ranks[0]["before"][k], k

    # detection on the mesh: under DP each rank's batch alone, exactly the
    # single-process result; under TP the wide convs gather their halves,
    # within JAX's TP tolerance (test_multichip.py::test_sharded_detector_tp)
    want = port_model("inference", port_config(OBJ_THRESHOLD=0.0), sd).detect_batch(images)
    got = np.load(tmp_path / "detect.npz")
    if mp == 1:
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    else:
        np.testing.assert_allclose(got["scores"], want["scores"].numpy(), rtol=1e-4, atol=1e-5)


def test_detect_and_evaluate_on_mesh_match_one_process(jax_setup, tmp_path):
    """2 ranks: detect_batch(mesh=) on 2 + 2 images, the int8
    detect_outputs(mesh=) after quantize, and evaluate_dataset(mesh=) equal
    the port in one process, bit for bit, on every rank; the detects run no
    collective (the JAX package's zero-collective DP detect,
    test_multichip.py::test_hlo_dp_detect_has_zero_collectives)."""
    _, _, _, sd = jax_setup
    rng = np.random.RandomState(11)
    images = (rng.rand(4, 64, 64, 3) * 255).astype(np.uint8)
    calib = rng.rand(2, 64, 64, 3).astype(np.float32)
    write_setup(tmp_path, sd, images=images, calib=calib)
    launch("detect", 2, tmp_path)

    cfg = port_config(OBJ_THRESHOLD=0.0)
    model = port_model("inference", cfg, sd)
    want = {f"float.{k}": v.numpy() for k, v in model.detect_batch(images).items()}
    want_eval = evaluate_dataset(model, shapes(6, seed=5), cfg, batch_size=4)
    want_eval.pop("per_image")
    model.quantize(calib)
    want.update({f"int8.{k}": v.numpy() for k, v in model.detect_batch(images).items()})
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert set(got.files) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"rank {rank} {k}")
        got_eval = json.load(open(tmp_path / f"eval{rank}.json"))
        assert got_eval.pop("collectives") == 0
        assert got_eval == json.loads(json.dumps(want_eval))


def test_train_on_mesh_writes_one_checkpoint_that_resumes_in_one_process(tmp_path):
    """MaskYOLO.train with DATA_PARALLEL = 2 for one epoch: the chief alone
    writes the checkpoint (and history), both ranks end with the same whole
    network, and the checkpoint resumes in one process."""
    launch("fit", 2, tmp_path)
    ckpts = sorted((tmp_path / "ckpt").glob("saved_model_*_e0001.pt"))
    assert len(ckpts) == 1
    assert len(open(tmp_path / "ckpt" / "history.jsonl").read().splitlines()) == 1
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for k in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)

    cfg = port_config(NUM_CLASSES=4, BATCH_SIZE=4,
                      LABELS=["background", "square", "circle", "triangle"])
    model = MaskYOLO("training", cfg, model_dir=str(tmp_path / "resumed"), seed=0,
                     device="cpu")
    model.load_weights(str(ckpts[0]))
    for k, v in model.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):   # not a checkpoint leaf
            np.testing.assert_array_equal(v.numpy(), ranks[0][k], err_msg=k)
    model.train(shapes(8, seed=2), shapes(4, seed=3), learning_rate=LR, epochs=2,
                resume_from=str(ckpts[0]), verbose=False)
    assert model.epoch == 2


def test_build_mesh_factorizations():
    """build_mesh against JAX's mesh.py:29-52 rule: DATA_PARALLEL = 0 is
    ranks // MODEL_PARALLEL, shrunk to divide the batch; explicit ones as
    given."""
    class C:
        DATA_PARALLEL = 4
        MODEL_PARALLEL = 2

    m = mesh_lib.build_mesh(C(), world_size=8)
    assert (m.dp, m.mp) == (4, 2) and m.axis_names == ("data", "model")
    assert m.shape == {"data": 4, "model": 2}

    class Auto:
        DATA_PARALLEL = 0
        MODEL_PARALLEL = 1

    assert mesh_lib.build_mesh(Auto(), world_size=8).dp == 8
    assert mesh_lib.build_mesh(Auto(), batch_size=12, world_size=8).dp == 6
    assert mesh_lib.build_mesh(Auto(), batch_size=7, world_size=8).dp == 7
    assert mesh_lib.build_mesh(Auto(), batch_size=5, world_size=4).dp == 1
    assert mesh_lib.build_mesh(None).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        mesh_lib.build_mesh(C(), world_size=4)


def test_build_mesh_matches_jax_rule():
    """The factorization and shrink of jax mesh.build_mesh on the same
    device counts, batches and settings."""
    import jax

    from mask_yolo_tpu.parallel import mesh as jmesh

    for dp, mp, batch in [(0, 1, 0), (0, 2, 0), (0, 1, 6), (0, 2, 3), (0, 4, 0), (2, 2, 0),
                          (4, 2, 0), (0, 1, 5)]:
        cfg = type("C", (), {"DATA_PARALLEL": dp, "MODEL_PARALLEL": mp})()
        want = jmesh.build_mesh(cfg, jax.devices(), batch_size=batch).devices.shape
        got = mesh_lib.build_mesh(cfg, batch_size=batch, world_size=len(jax.devices()))
        assert (got.dp, got.mp) == want, (dp, mp, batch)


def test_param_shardings_match_jax_rule(jax_setup):
    """Leaf for leaf: a port parameter or statistic is sharded exactly where
    JAX's param_shardings shards the flax leaf (on its output-channel dim)."""
    import jax

    from mask_yolo_tpu.parallel import mesh as jmesh

    _, _, v, _ = jax_setup
    cfg = type("C", (), {"DATA_PARALLEL": 4, "MODEL_PARALLEL": 2})()
    jm = jmesh.build_mesh(cfg, jax.devices())
    jsh = jmesh.param_shardings(v, jm)
    jsharded = {"/".join(str(getattr(k, "key", k)) for k in path): "model" in str(s.spec)
                for path, s in jax.tree_util.tree_flatten_with_path(jsh)[0]}

    class FakeMesh:
        mp = 2

    net = MaskYOLO("training", port_config(), device="cpu").net
    sh = mesh_lib.param_shardings(net, FakeMesh())
    for key, t in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, path = weights.flax_leaf(key, t.dim())[0], weights.flax_path(key, t.dim())
        flat = ("params/" if coll == "params" else "batch_stats/") + path
        assert (sh[key] is not None) == jsharded[flat], key
    assert sum(d is not None for d in sh.values()) > 20


def test_local_image_ids_match_jax():
    from mask_yolo_tpu.parallel import distributed as jdist

    for n, count in [(10, 2), (7, 3), (16, 4), (5, 5)]:
        for i in range(count):
            np.testing.assert_array_equal(distributed.local_image_ids(np.arange(n), i, count),
                                          jdist.local_image_ids(np.arange(n), i, count))
    with pytest.raises(ValueError):
        distributed.local_image_ids(np.arange(2), 0, 3)
    batch = {"image": np.zeros((2, 4))}
    assert distributed.global_batch_from_local(batch) is batch


def test_initialize_single_process_noop(monkeypatch):
    for var in ("MYOLO_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") == (0, 1)
    assert distributed.is_chief()
    distributed.shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    case, workdir, *rest = sys.argv[1:]
    {"train": lambda: worker_train(workdir, int(rest[0]), int(rest[1]), *rest[2:]),
     "detect": lambda: worker_detect(workdir),
     "fit": lambda: worker_fit(workdir)}[case]()
