"""Waymo-protocol detection metrics without the devkit — port of
findnpropagate_tpu/datasets/waymo_eval.py (numpy, with the 3D IoU of
ops/rotated_iou.py on CPU tensors).

LEVEL_1 / LEVEL_2 AP and APH per class: classes Vehicle / Pedestrian /
Sign / Cyclist, 3D IoU thresholds 0.7 / 0.5 / 0.5 / 0.5, and the difficulty
fixup from num_points_in_gt (> 5 -> LEVEL_1 else LEVEL_2, boxes without
points dropped). Matching is greedy in score order (the official tool asks
for Hungarian; greedy differs only on dense overlapping scenes), and AP
integrates the full envelope PR curve instead of sampling 101 score
cutoffs. APH weighs each TP by 1 - |wrapped heading error| / pi.
Detections without names count in every class.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotated_iou import boxes_iou3d

WAYMO_CLASSES = ("Vehicle", "Pedestrian", "Sign", "Cyclist")
IOU_THRESHOLDS = {"Vehicle": 0.7, "Pedestrian": 0.5, "Sign": 0.5,
                  "Cyclist": 0.5}


def _fixup_difficulty(info):
    """Unannotated difficulty (0) becomes LEVEL_1 when
    the box holds > 5 points, else LEVEL_2; empty boxes are dropped."""
    diff = np.asarray(info.get("difficulty", np.ones(len(info["name"]))),
                      np.int64).copy()
    keep = np.ones(len(diff), bool)
    if "num_points_in_gt" in info:
        npts = np.asarray(info["num_points_in_gt"])
        zero = diff == 0
        diff[(npts > 5) & zero] = 1
        diff[(npts <= 5) & zero] = 2
        keep = npts > 0
    else:
        diff[diff == 0] = 1
    return diff, keep


def _heading_sim(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    d = np.where(d > np.pi, 2 * np.pi - d, d)
    return 1.0 - d / np.pi


def _ap_from_matches(matches, num_gt, use_heading=False):
    """matches: (score, tp, heading_sim) rows; full-curve envelope AP."""
    if num_gt == 0 or not matches:
        return 0.0
    arr = np.asarray(matches)
    order = np.argsort(-arr[:, 0])
    tp = arr[order, 1]
    num = tp * arr[order, 2] if use_heading else tp
    cum_tp = np.cumsum(tp)
    cum_num = np.cumsum(num)
    cum_fp = np.cumsum(1 - tp)
    recall = cum_tp / num_gt
    precision = cum_num / np.maximum(cum_tp + cum_fp, 1)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    prev_r = 0.0
    ap = 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return ap


def eval_class_level(gt_annos, det_annos, cls_name, level):
    """One (class, level) matching pass. gt_annos: per-frame dicts with
    name / gt_boxes_lidar / difficulty / num_points_in_gt; det_annos:
    name / boxes_lidar (or boxes) / score. LEVEL_1 treats LEVEL_2 gts as
    ignored; LEVEL_2 counts every kept gt."""
    thresh = IOU_THRESHOLDS.get(cls_name, 0.5)
    matches = []
    num_gt_total = 0
    for gt, det in zip(gt_annos, det_annos):
        names = np.asarray(gt.get("name", []))
        diff, keep = _fixup_difficulty(gt) if len(names) else \
            (np.zeros(0, np.int64), np.zeros(0, bool))
        cls_mask = (names == cls_name) & keep
        gt_boxes = np.asarray(
            gt.get("gt_boxes_lidar", np.zeros((0, 7))))[:, :7] \
            if len(names) else np.zeros((0, 7))
        care = cls_mask & (diff <= level)
        ignored = cls_mask & (diff > level)
        num_gt_total += int(care.sum())

        det_names = np.asarray(det.get("name", []))
        det_boxes = np.asarray(
            det.get("boxes_lidar", det.get("boxes", np.zeros((0, 7)))))
        det_scores = np.asarray(det.get("score", det.get("scores", [])))
        dm = det_names == cls_name if len(det_names) else \
            np.ones(len(det_boxes), bool)
        det_boxes = det_boxes[dm][:, :7] if len(det_boxes) else det_boxes
        det_scores = det_scores[dm]
        if len(det_boxes) == 0:
            continue
        if len(gt_boxes) == 0 or not cls_mask.any():
            matches.extend((s, 0, 0.0) for s in det_scores)
            continue
        iou = boxes_iou3d(torch.from_numpy(det_boxes.astype(np.float32)),
                          torch.from_numpy(gt_boxes.astype(np.float32))
                          ).numpy()
        assigned = np.zeros(len(gt_boxes), bool)
        for di in np.argsort(-det_scores):
            row = iou[di].copy()
            row[assigned] = -1
            care_row = np.where(care, row, -1.0)
            gi = int(np.argmax(care_row))
            if care_row[gi] >= thresh:
                assigned[gi] = True
                sim = _heading_sim(det_boxes[di, 6], gt_boxes[gi, 6])
                matches.append((det_scores[di], 1, sim))
                continue
            ign_row = np.where(ignored, row, -1.0)
            gi = int(np.argmax(ign_row))
            if ign_row[gi] >= thresh:
                assigned[gi] = True
            else:
                matches.append((det_scores[di], 0, 0.0))
    return matches, num_gt_total


def waymo_eval(gt_annos, det_annos, class_names=None):
    """Returns (result_str, result_dict) with
    OBJECT_TYPE_TYPE_<CLS>_LEVEL_<L>/AP and /APH keys (the official
    tool's key layout)."""
    class_names = tuple(class_names or ("Vehicle", "Pedestrian", "Cyclist"))
    result = {}
    for cls in class_names:
        for level in (1, 2):
            matches, num_gt = eval_class_level(gt_annos, det_annos, cls,
                                               level)
            ap = _ap_from_matches(matches, num_gt) * 100.0
            aph = _ap_from_matches(matches, num_gt, use_heading=True) * 100.0
            result[f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_{level}/AP"] = ap
            result[f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_{level}/APH"] = aph
    lines = [f"{k}: {v:.4f}" for k, v in result.items()]
    return "\n".join(lines), result
