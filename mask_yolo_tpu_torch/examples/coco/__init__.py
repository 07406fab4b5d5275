"""The coco example scripts (`python -m mask_yolo_tpu_torch.examples.coco.<script>`)."""
