"""The shapes example scripts (`python -m mask_yolo_tpu_torch.examples.shapes.<script>`)."""
