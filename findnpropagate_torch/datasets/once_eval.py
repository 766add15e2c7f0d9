"""ONCE-protocol AP without the devkit — port of
findnpropagate_tpu/datasets/once_eval.py (numpy, with the rotated BEV
overlap of ops/rotated_iou.py on CPU tensors).

Superclass grouping (Car / Bus / Truck -> Vehicle), per-class IoU
thresholds, the heading-gated 3D IoU (pairs whose yaw differs by more than
90 degrees never match), score thresholds at 50 recall positions
(KITTI-style), the two-pass ignore-aware greedy matcher, and the overall /
0-30m / 30-50m / 50m-inf buckets. Detections are read from `boxes_3d`,
`name` and `score`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotated_iou import boxes_overlap_bev

IOU_THRESHOLDS = {"Car": 0.7, "Bus": 0.7, "Truck": 0.7,
                  "Pedestrian": 0.3, "Cyclist": 0.5}
SUPERCLASS_IOU_THRESHOLDS = {"Vehicle": 0.7, "Pedestrian": 0.3,
                             "Cyclist": 0.5}
DIFFICULTY_TYPES = ["overall", "0-30m", "30-50m", "50m-inf"]


def heading_gated_iou3d(gt_boxes, pred_boxes):
    """(N, 7) x (M, 7) -> (N, M) 3D IoU, zeroed where the wrapped yaw
    difference exceeds pi/2."""
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return np.zeros((len(gt_boxes), len(pred_boxes)))
    inter_2d = boxes_overlap_bev(
        torch.from_numpy(gt_boxes.astype(np.float32)),
        torch.from_numpy(pred_boxes.astype(np.float32))).numpy().astype(
            np.float64)
    gt_hi = gt_boxes[:, 2:3] + gt_boxes[:, 5:6] * 0.5
    gt_lo = gt_boxes[:, 2:3] - gt_boxes[:, 5:6] * 0.5
    pr_hi = pred_boxes[:, 2:3] + pred_boxes[:, 5:6] * 0.5
    pr_lo = pred_boxes[:, 2:3] - pred_boxes[:, 5:6] * 0.5
    inter_h = np.clip(np.minimum(gt_hi, pr_hi.T) - np.maximum(gt_lo, pr_lo.T),
                      0, None)
    inter_3d = inter_2d * inter_h
    vol_g = np.prod(gt_boxes[:, 3:6], axis=1, keepdims=True)
    vol_p = np.prod(pred_boxes[:, 3:6], axis=1, keepdims=True)
    iou = inter_3d / np.maximum(vol_g + vol_p.T - inter_3d, 1e-9)
    diff_rot = np.abs(gt_boxes[:, 6:7] - pred_boxes[:, 6:7].T)
    diff_rot = np.where(diff_rot >= np.pi, 2 * np.pi - diff_rot, diff_rot)
    iou[diff_rot > np.pi / 2] = 0.0
    return iou


def _flags(names, boxes, class_name, level, use_superclass):
    """-1 rejected (other class), 1 ignored (other distance bucket),
    0 accepted (filter_data + overall_distance_filter semantics)."""
    names = np.asarray(names)
    n = len(names)
    flag = np.zeros(n, np.int64)
    if use_superclass and class_name == "Vehicle":
        reject = (names == "Pedestrian") | (names == "Cyclist")
    else:
        reject = names != class_name
    flag[reject] = -1
    if level > 0:
        dist = np.linalg.norm(np.asarray(boxes)[:, :3], axis=1) \
            if len(boxes) else np.zeros(0)
        if level == 1:
            inside = dist < 30
        elif level == 2:
            inside = (dist >= 30) & (dist < 50)
        else:
            inside = dist >= 50
        flag[(flag == 0) & ~inside] = 1
    return flag


def _accumulate_scores(iou, pred_scores, gt_flag, pred_flag, thresh):
    """First pass: TP scores for threshold selection: each accepted gt greedily takes its highest-score unassigned overlapping
    prediction; matches involving an ignored side are consumed silently."""
    assigned = np.zeros(len(pred_scores), bool)
    out = []
    for i in range(iou.shape[0]):
        if gt_flag[i] == -1:
            continue
        cand = np.where(
            (pred_flag != -1) & ~assigned & (iou[i] > thresh))[0]
        if len(cand) == 0:
            continue
        j = cand[np.argmax(pred_scores[cand])]
        assigned[j] = True
        if gt_flag[i] == 0 and pred_flag[j] == 0:
            out.append(pred_scores[j])
    return out


def _statistics(iou, pred_scores, gt_flag, pred_flag, score_th, thresh):
    """Second pass: per score threshold, best-IoU
    matching with accepted preds preferred over ignored ones."""
    assigned = np.zeros(len(pred_scores), bool)
    under = pred_scores < score_th
    tp = fp = fn = 0
    for i in range(iou.shape[0]):
        if gt_flag[i] == -1:
            continue
        det_idx = -1
        best_iou = 0.0
        to_ignore = False
        detected = False
        for j in range(iou.shape[1]):
            if pred_flag[j] == -1 or assigned[j] or under[j]:
                continue
            iou_ij = iou[i, j]
            if iou_ij > thresh and (iou_ij > best_iou or to_ignore) \
                    and pred_flag[j] == 0:
                best_iou = iou_ij
                det_idx = j
                detected = True
                to_ignore = False
            elif iou_ij > thresh and not detected and pred_flag[j] == 1:
                det_idx = j
                detected = True
                to_ignore = True
        if not detected and gt_flag[i] == 0:
            fn += 1
        elif detected and (gt_flag[i] == 1 or pred_flag[det_idx] == 1):
            assigned[det_idx] = True
        elif detected:
            tp += 1
            assigned[det_idx] = True
    fp = int(np.sum(~assigned & (pred_flag == 0) & ~under))
    return tp, fp, fn


def _score_thresholds(scores, num_gt, num_pr_points):
    """KITTI-style recall-spaced score thresholds."""
    eps = 1e-6
    scores = np.sort(np.asarray(scores))[::-1]
    recall_level = 0.0
    out = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall + l_recall < 2 * recall_level) and i < len(scores) - 1:
            continue
        out.append(score)
        recall_level += 1 / num_pr_points
        while r_recall + l_recall + eps > 2 * recall_level:
            out.append(score)
            recall_level += 1 / num_pr_points
    return out


def once_eval(gt_annos, det_annos, classes, use_superclass=True,
              iou_thresholds=None, num_pr_points=50,
              difficulty_mode="Overall&Distance"):
    """gt_annos/det_annos: per-frame dicts with name (str array),
    boxes_3d (N, 7) and (dets) score. Returns (result_str, result_dict)
    with AP_<class>/<difficulty> keys like the official tool."""
    if iou_thresholds is None:
        iou_thresholds = SUPERCLASS_IOU_THRESHOLDS if use_superclass \
            else IOU_THRESHOLDS
    classes = list(classes)
    if use_superclass:
        classes = [c for c in classes if c not in ("Car", "Bus", "Truck")]
        classes.insert(0, "Vehicle")
    if difficulty_mode == "Overall":
        levels = [0]
    elif difficulty_mode == "Distance":
        levels = [1, 2, 3]
    else:
        levels = [0, 1, 2, 3]

    ious = [
        heading_gated_iou3d(
            np.asarray(g.get("boxes_3d", np.zeros((0, 7))), np.float64),
            np.asarray(d.get("boxes_3d", np.zeros((0, 7))), np.float64))
        for g, d in zip(gt_annos, det_annos)
    ]

    result = {}
    ap_matrix = np.zeros((len(classes), len(levels)))
    for ci, cls in enumerate(classes):
        thresh = iou_thresholds[cls]
        for li, level in enumerate(levels):
            gt_flags, pred_flags, all_scores = [], [], []
            num_valid_gt = 0
            for g, d, iou in zip(gt_annos, det_annos, ious):
                gf = _flags(g.get("name", []), g.get("boxes_3d", []),
                            cls, level, use_superclass)
                pf = _flags(d.get("name", []), d.get("boxes_3d", []),
                            cls, level, use_superclass)
                gt_flags.append(gf)
                pred_flags.append(pf)
                num_valid_gt += int(np.sum(gf == 0))
                all_scores.extend(_accumulate_scores(
                    iou, np.asarray(d.get("score", [])), gf, pf, thresh))
            if num_valid_gt == 0:
                continue
            thresholds = _score_thresholds(all_scores, num_valid_gt,
                                           num_pr_points)
            cm = np.zeros((len(thresholds), 3))
            for g, d, iou, gf, pf in zip(gt_annos, det_annos, ious,
                                         gt_flags, pred_flags):
                scores = np.asarray(d.get("score", []))
                for ti, score_th in enumerate(thresholds):
                    tp, fp, fn = _statistics(iou, scores, gf, pf,
                                             score_th, thresh)
                    cm[ti] += (tp, fp, fn)
            precision = np.zeros(num_pr_points + 1)
            precision[: len(thresholds)] = cm[:, 0] / np.maximum(
                cm[:, 0] + cm[:, 1], 1e-9)
            for ti in range(len(precision)):
                precision[ti] = np.max(precision[ti:])
            ap = np.sum(precision[1:]) / num_pr_points * 100.0
            ap_matrix[ci, li] = ap
            result[f"AP_{cls}/{DIFFICULTY_TYPES[level]}"] = ap
    for li, level in enumerate(levels):
        result[f"AP_mean/{DIFFICULTY_TYPES[level]}"] = float(
            np.mean(ap_matrix[:, li]))
    lines = [f"{k}: {v:.2f}" for k, v in result.items()]
    return "\n".join(lines), result
