"""The port's example scripts, under the JAX package's `examples/` file
names: `python -m mask_yolo_tpu_torch.examples.<dataset>.<script> --help`."""
