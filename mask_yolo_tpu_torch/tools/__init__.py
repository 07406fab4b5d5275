"""The port's command-line tools, one module each under the JAX package's
`tools/` file names: `python -m mask_yolo_tpu_torch.tools.<name> --help`."""
