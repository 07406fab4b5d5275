"""The food example scripts (`python -m mask_yolo_tpu_torch.examples.food.<script>`)."""
