"""What the command-line tools and example scripts share: the `--device`
flag and reading a weights file."""

from __future__ import annotations


def add_device_flag(ap):
    """`--device`: where the model runs. The card unless the caller asks for
    the CPU; on a machine without CUDA the default fails, it never falls
    back."""
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (default: cuda; 'cpu' to run "
                         "without a GPU)")


def load_weights(model, path):
    """Load a checkpoint of `MaskYOLO.save_weights` or `train` (the port's
    format), or a Keras-2 `.h5` / `.hdf5` file of the reference codebase
    (`load_weights_from_keras_h5`, needs h5py). The JAX package's orbax
    directories are not read."""
    if str(path).endswith((".h5", ".hdf5")):
        model.load_weights_from_keras_h5(str(path))
    else:
        model.load_weights(str(path))
