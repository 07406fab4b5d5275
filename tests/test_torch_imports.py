"""The PyTorch port runs without JAX: no module of `mask_yolo_tpu_torch`, and
not `chip_smoke.py`, imports jax, flax or the JAX package. The machine with
the GPU has no JAX at all."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mask_yolo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "flax", "mask_yolo_tpu")


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'mask_yolo_tpu'):\n"
        "    sys.modules[name] = None  # any import of them now raises\n"
        "import importlib, pkgutil\n"
        "import mask_yolo_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mask_yolo_tpu_torch.__path__, 'mask_yolo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every .py of the package except the top-level __init__
    assert int(proc.stdout.strip()) == len(PORT_FILES) - 2


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_statement(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, f"{path}: imports {name}"


# the training slice's modules: each must exist, so that both tests above
# cover it
TRAINING_SLICE = ("losses", "ops.target_assign", "train.state", "train.trainer",
                  "utils.image", "data.dataset", "data.loader", "data.encoder",
                  "data.pipeline", "data.prefetch", "data.shapes")


@pytest.mark.parametrize("name", TRAINING_SLICE)
def test_training_slice_module_is_covered(name):
    assert ROOT / "mask_yolo_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES


# the modules of the infer_yolo, augmentation and evaluation paths
USER_PATHS_SLICE = ("ops.nms", "utils.host_ops", "utils.metrics", "evaluate", "data.augment",
                    "native.__init__")


@pytest.mark.parametrize("name", USER_PATHS_SLICE)
def test_user_paths_module_is_covered(name):
    assert ROOT / "mask_yolo_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES


def test_importing_the_port_builds_nothing_and_starts_no_process():
    """The native image library is built at first use, not at import."""
    code = ("import subprocess, sys\n"
            "def refuse(*a, **k): raise AssertionError('a process was started at import')\n"
            "subprocess.run = subprocess.Popen = refuse\n"
            "import mask_yolo_tpu_torch.native, mask_yolo_tpu_torch.utils.image\n"
            "import mask_yolo_tpu_torch.evaluate, mask_yolo_tpu_torch.data.pipeline\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# the host-side modules of the datasets, the anchors, the drawing and the
# Keras-h5 interop
HOST_SLICE = ("utils.anchors", "utils.visualize", "utils.keras_h5", "data.dense_shapes",
              "data.coco", "data.via")
OPTIONAL = ("h5py", "matplotlib", "PIL")


@pytest.mark.parametrize("name", HOST_SLICE)
def test_host_module_is_covered(name):
    assert ROOT / "mask_yolo_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES


def test_importing_the_port_pulls_in_no_optional_package():
    """h5py, matplotlib and PIL are imported inside the functions that need
    them: importing every module of the port, and chip_smoke.py, works with
    all three blocked (the machine with the GPU has none of them)."""
    code = (
        "import sys\n"
        f"for name in {OPTIONAL + BANNED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import mask_yolo_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(mask_yolo_tpu_torch.__path__, 'mask_yolo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"print([n for n in sys.modules if n.split('.')[0] in {OPTIONAL!r}\n"
        "       and sys.modules[n] is not None])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# the export and parallel slice's modules, covered the same way (the rank
# workers of tests/test_torch_parallel.py import them with no JAX present)
EXPORT_PARALLEL_SLICE = ("export", "parallel.collectives", "parallel.mesh",
                         "parallel.distributed", "parallel.inference")


@pytest.mark.parametrize("name", EXPORT_PARALLEL_SLICE)
def test_export_parallel_module_is_covered(name):
    assert ROOT / "mask_yolo_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES


# the ResNet-50 + FPN backbone, the last module of the JAX package to be
# ported, covered the same way
FPN_SLICE = ("models.resnet_fpn", "models.network", "ops.roi_align", "ops.roi_crop")


@pytest.mark.parametrize("name", FPN_SLICE)
def test_fpn_module_is_covered(name):
    assert ROOT / "mask_yolo_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES
