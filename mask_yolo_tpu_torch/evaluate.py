"""Quantitative evaluation harness: mAP over a Dataset — port of
`mask_yolo_tpu/evaluate.py`.

Runs the batched on-device detect pipeline over a dataset and scores it with
the VOC/COCO-style metrics in utils/metrics.py (box and mask AP). The AP
callback hands the weights a `train` is updating to an inference model on
the same device, tensor to tensor, without a host round trip.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .data.loader import load_image_gt
from .utils import metrics


def evaluate_dataset(model, dataset, config, image_ids=None, batch_size=8,
                     iou_threshold=0.5, score_threshold=0.0, verbose=False,
                     mesh=None):
    """Run detection over `dataset` and compute detection + mask AP.

    model: a MaskYOLO in 'inference' mode (uses detect_batch).
    Returns dict with pooled (true VOC/COCO definition: detections pooled
    across the dataset before the PR curve — metrics.APAccumulator) box_ap50,
    box_map (COCO 0.5:0.95), mask_ap50, mask_map; plus mean_recall50 and
    per_image (per-image AP dicts, mean reported as box_ap50_per_image for
    continuity with round-1 numbers).

    mesh: sharding an eval batch over devices is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "evaluate_dataset(mesh=) is not ported yet (ROADMAP Queue 1 #8, item 11: "
            "parallel, a data-parallel detector)")
    if image_ids is None:
        image_ids = list(dataset.image_ids)

    h, w = config.IMAGE_SHAPE[:2]
    per_image = []
    acc = metrics.APAccumulator()
    box_ap50s, mask_ap50s, box_maps, recalls = [], [], [], []

    for start in range(0, len(image_ids), batch_size):
        chunk = image_ids[start:start + batch_size]
        images, gts = [], []
        for image_id in chunk:
            image, gt_ids, gt_boxes, gt_masks = load_image_gt(
                dataset, config, image_id, use_mini_mask=False)
            images.append(image.astype(np.float32) / 255.0)
            gts.append((gt_ids, gt_boxes.astype(np.float64), gt_masks))
        batch = np.stack(images)
        # pad the trailing batch so every batch has one shape, as the JAX
        # package does (batch statistics play no part at inference, so the
        # padding changes no result)
        if batch.shape[0] < batch_size:
            pad = batch_size - batch.shape[0]
            batch = np.concatenate(
                [batch, np.zeros((pad, h, w, 3), np.float32)])
        # model may be any duck-typed object with a detect_batch(images)
        out = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
               for k, v in model.detect_batch(batch).items()}

        for bi, (gt_ids, gt_boxes, gt_masks) in enumerate(gts):
            keep = out["valid"][bi] & (out["scores"][bi] >= score_threshold)
            idx = np.where(keep)[0]
            pred_boxes = out["boxes"][bi][idx].astype(np.float64)
            pred_ids = out["classes"][bi][idx]
            pred_scores = out["scores"][bi][idx].astype(np.float64)
            pred_masks = np.transpose(out["masks"][bi][idx], (1, 2, 0))

            acc.add(gt_boxes, gt_ids, gt_masks,
                    pred_boxes, pred_ids, pred_scores, pred_masks)

            if len(gt_ids) == 0 and len(pred_ids) == 0:
                # a correct empty image: per-image AP scores it 1.0 (the old
                # n_gt=max(G,1) fallback wrongly penalized it with 0.0)
                box_ap = box_map = mask_ap = 1.0
            else:
                box_ap, _, _, _ = metrics.compute_ap(
                    gt_boxes, gt_ids, None, pred_boxes, pred_ids, pred_scores,
                    iou_threshold=iou_threshold)
                box_map = metrics.compute_ap_range(
                    gt_boxes, gt_ids, None, pred_boxes, pred_ids, pred_scores)
                mask_ap, _, _, _ = metrics.compute_ap(
                    gt_boxes, gt_ids, gt_masks, pred_boxes, pred_ids,
                    pred_scores, pred_masks, iou_threshold=iou_threshold)
            recall, _ = metrics.compute_recall(pred_boxes, gt_boxes,
                                               iou=iou_threshold)
            per_image.append({"image_id": chunk[bi], "box_ap50": box_ap,
                              "box_map": box_map, "mask_ap50": mask_ap,
                              "recall50": recall,
                              "n_gt": len(gt_ids), "n_pred": len(pred_ids)})
            box_ap50s.append(box_ap)
            box_maps.append(box_map)
            mask_ap50s.append(mask_ap)
            recalls.append(recall)
            if verbose:
                print(f"image {chunk[bi]}: box AP50 {box_ap:.3f} "
                      f"mask AP50 {mask_ap:.3f} recall {recall:.3f}")

    result = {
        # pooled, dataset-level metrics (the real VOC/COCO definition)
        "box_ap50": acc.ap(iou_threshold, use_masks=False),
        "box_map": acc.map_range(use_masks=False),
        "mask_ap50": acc.ap(iou_threshold, use_masks=True),
        "mask_map": acc.map_range(use_masks=True),
        # per-image means kept for continuity with round-1 reports
        "box_ap50_per_image": float(np.mean(box_ap50s)) if box_ap50s else 0.0,
        "box_map_per_image": float(np.mean(box_maps)) if box_maps else 0.0,
        "mask_ap50_per_image": (float(np.mean(mask_ap50s))
                                if mask_ap50s else 0.0),
        "mean_recall50": float(np.mean(recalls)) if recalls else 0.0,
        "n_images": len(per_image),
        "per_image": per_image,
    }
    return result


def make_ap_eval_callback(eval_dataset, config, every: int = 5,
                          batch_size: int = 8, score_threshold: float = 0.35,
                          history_path: str | None = None,
                          best_weights_path: str | None = None,
                          track: str = "box_ap50", verbose: bool = True):
    """Build a MaskYOLO.train `custom_callbacks` entry that evaluates pooled
    AP on `eval_dataset` every `every` epochs with the in-flight weights.

    val_loss is a misleading model-selection signal for this detector (the
    JAX package's docs/PERFORMANCE.md, "80-class operating point": it can
    rise while box AP50 keeps climbing), so early stopping or
    best-checkpoint selection must watch AP, not val_loss.

    The inference model is built once, on the device of the training
    network; each evaluation copies the in-flight parameters and BatchNorm
    statistics into it on that device (cast to its compute dtype) and drops
    its int8 detector.

    history_path: append one JSON line per evaluation ({"epoch", metrics...}).
    best_weights_path: save weights whenever metrics[track] improves.
    Returns the callback; the callback object exposes `.history` (list) and
    `.best` (best tracked value so far).
    """
    from . import model as model_lib

    _tracks = ("box_ap50", "box_map", "mask_ap50", "mask_map",
               "box_ap50_per_image", "box_map_per_image",
               "mask_ap50_per_image", "mean_recall50")
    if track not in _tracks:
        raise ValueError(f"track={track!r} not one of {_tracks}")

    state_holder = {"infer": None, "best": -1.0}
    # the best-so-far value persists next to the weights so segmented runs
    # (several resumed processes) don't let a weaker later epoch overwrite
    # an earlier best checkpoint
    best_sidecar = (best_weights_path + ".best.json"
                    if best_weights_path else None)
    if best_sidecar and os.path.exists(best_sidecar):
        with open(best_sidecar) as f:
            state_holder["best"] = float(json.load(f).get(track, -1.0))

    def cb(epoch, train_metrics, val_loss, state):
        # `epoch` is 0-based (train() invokes callbacks after epoch+1 epochs
        # have run); evaluate on every `every`-th completed epoch so a run
        # whose total divides by `every` always ends with an evaluation
        del train_metrics, val_loss
        if (epoch + 1) % every:
            return
        if state_holder["infer"] is None:
            state_holder["infer"] = model_lib.MaskYOLO(
                mode="inference", config=config,
                device=next(state.net.parameters()).device)
        infer = state_holder["infer"]
        infer._load_live_state(state.params, state.batch_stats)
        result = evaluate_dataset(infer, eval_dataset, config,
                                  batch_size=batch_size,
                                  score_threshold=score_threshold)
        result.pop("per_image", None)
        entry = {"epoch": int(epoch) + 1, **result}
        cb.history.append(entry)
        if verbose:
            print(f"  eval@{epoch + 1}: box_ap50 {result['box_ap50']:.3f} "
                  f"mask_ap50 {result['mask_ap50']:.3f} "
                  f"recall {result['mean_recall50']:.3f}")
        if history_path:
            with open(history_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        if result.get(track, 0.0) > state_holder["best"]:
            state_holder["best"] = float(result[track])
            cb.best = state_holder["best"]
            if best_weights_path:
                infer.save_weights(best_weights_path)
                with open(best_sidecar, "w") as f:
                    json.dump({track: state_holder["best"],
                                "epoch": int(epoch) + 1}, f)

    cb.history = []
    cb.best = state_holder["best"]
    return cb
