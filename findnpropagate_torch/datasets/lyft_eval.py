"""The Lyft mAP protocol without the devkit — port of
findnpropagate_tpu/datasets/lyft_eval.py (numpy, with the 3D IoU of
ops/rotated_iou.py on CPU tensors).

Per class, AP averaged over the IoU thresholds 0.5:0.95:0.05:

  * greedy per-prediction matching in global score order; a prediction
    matches the single highest-IoU gt of its sample and is a TP at a
    threshold only if that gt is unclaimed at that threshold;
  * VOC-envelope AP over the raw PR points;
  * classes absent from the predictions score AP 0; classes absent from
    the gt are skipped.

The 3D IoU is the exact rotated-BEV polygon clip times the z overlap (the
devkit's shapely polygons compute the same quantity).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotated_iou import boxes_iou3d

DEFAULT_IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def get_envelope(precisions):
    """Monotone non-increasing precision envelope."""
    out = precisions.copy()
    for i in range(out.size - 1, 0, -1):
        out[i - 1] = np.maximum(out[i - 1], out[i])
    return out


def get_ap(recalls, precisions):
    """VOC-style AP over the PR curve."""
    r = np.concatenate(([0.0], recalls, [1.0]))
    p = np.concatenate(([0.0], precisions, [0.0]))
    p = get_envelope(p)
    i = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[i + 1] - r[i]) * p[i + 1]))


def _iou3d(det_boxes, gt_boxes):
    return boxes_iou3d(
        torch.from_numpy(np.asarray(det_boxes[:, :7], np.float32)),
        torch.from_numpy(np.asarray(gt_boxes[:, :7], np.float32))).numpy()


def recall_precision(gt, predictions, iou_thresholds):
    """One class. gt / predictions: lists of dicts with sample_token,
    box7 (x y z dx dy dz yaw), and score (predictions). Returns
    (recalls, precisions, ap_list) over thresholds, or (-1, -1, -1) when
    the class has no gt."""
    num_gts = len(gt)
    if num_gts == 0:
        return -1, -1, -1
    t = len(iou_thresholds)

    sample_gts = {}
    for g in gt:
        sample_gts.setdefault(g["sample_token"], []).append(
            np.asarray(g["box7"], np.float64))
    gt_arr = {k: np.stack(v) for k, v in sample_gts.items()}
    gt_checked = {k: np.zeros((len(v), t)) for k, v in gt_arr.items()}

    preds = sorted(predictions, key=lambda x: x["score"], reverse=True)
    tp = np.zeros((len(preds), t))
    fp = np.zeros((len(preds), t))
    for pi, pred in enumerate(preds):
        token = pred["sample_token"]
        max_ov, jmax = -np.inf, -1
        if token in gt_arr:
            ious = _iou3d(np.asarray(pred["box7"], np.float64)[None],
                          gt_arr[token])[0]
            max_ov = float(ious.max())
            jmax = int(ious.argmax())
        for i, thr in enumerate(iou_thresholds):
            if max_ov > thr:
                if gt_checked[token][jmax, i] == 0:
                    tp[pi, i] = 1.0
                    gt_checked[token][jmax, i] = 1
                else:
                    fp[pi, i] = 1.0
            else:
                fp[pi, i] = 1.0

    fp = np.cumsum(fp, axis=0)
    tp = np.cumsum(tp, axis=0)
    recalls = tp / float(num_gts)
    precisions = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap_list = [get_ap(recalls[:, i], precisions[:, i]) for i in range(t)]
    return recalls, precisions, ap_list


def get_average_precisions(gt, predictions, class_names,
                           iou_thresholds=DEFAULT_IOU_THRESHOLDS):
    """Per-class AP averaged over IoU thresholds."""
    by_cls_gt = {}
    for g in gt:
        by_cls_gt.setdefault(g["name"], []).append(g)
    by_cls_pred = {}
    for p in predictions:
        by_cls_pred.setdefault(p["name"], []).append(p)
    aps = np.zeros(len(class_names))
    for ci, name in enumerate(class_names):
        if name in by_cls_pred and name in by_cls_gt:
            _, _, ap_list = recall_precision(
                by_cls_gt[name], by_cls_pred[name], list(iou_thresholds))
            aps[ci] = float(np.mean(ap_list))
    return aps


def lyft_eval(gt_annos, det_annos, class_names,
              iou_thresholds=DEFAULT_IOU_THRESHOLDS):
    """Framework-facing wrapper. gt_annos: per-frame dicts with
    gt_boxes (M, 7) and gt_names; det_annos: per-frame dicts with
    boxes (K, 7), scores, name. Returns (result string, metrics dict with
    per-class AP and mAP)."""
    gt, preds = [], []
    for fi, g in enumerate(gt_annos):
        boxes = np.asarray(g.get("gt_boxes", np.zeros((0, 7))))
        names = list(g.get("gt_names", []))
        for b, n in zip(boxes, names):
            gt.append({"sample_token": str(fi), "box7": b[:7], "name": n})
    for fi, d in enumerate(det_annos):
        boxes = np.asarray(d.get("boxes", np.zeros((0, 7))))
        scores = np.asarray(d.get("scores", np.zeros(len(boxes))))
        names = list(d.get("name", []))
        for b, s, n in zip(boxes, scores, names):
            preds.append({"sample_token": str(fi), "box7": b[:7],
                          "name": n, "score": float(s)})
    aps = get_average_precisions(gt, preds, class_names, iou_thresholds)
    metrics = {f"AP_{n}": float(a) for n, a in zip(class_names, aps)}
    metrics["mAP"] = float(np.mean(aps)) if len(aps) else 0.0
    lines = [f"{n}: {a:.4f}" for n, a in zip(class_names, aps)]
    lines.append(f"mAP (IoU 0.5:0.95): {metrics['mAP']:.4f}")
    return "\n".join(lines), metrics
