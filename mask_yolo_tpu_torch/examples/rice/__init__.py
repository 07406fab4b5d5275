"""The rice example scripts (`python -m mask_yolo_tpu_torch.examples.rice.<script>`)."""
