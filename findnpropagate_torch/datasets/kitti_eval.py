"""KITTI-protocol AP evaluation (R40 / R11, difficulty buckets, rotated
IoU) — port of findnpropagate_tpu/datasets/kitti_eval.py (numpy).

40- and 11-point interpolated AP, per-class IoU thresholds (0.7 car / 0.5
others), easy / moderate / hard difficulty gating by box height, occlusion
and truncation, ignored boxes (DontCare, Van for Car, Person_sitting for
Pedestrian), greedy score-ordered matching with the rotated BEV / 3D IoU
of ops/rotated_iou.py run on the CPU, and AOS where 2D boxes and alphas
are given.
"""

from __future__ import annotations

import numpy as np

import torch

from ..ops.rotated_iou import boxes_iou3d, boxes_iou_bev

# official difficulty gates
MIN_HEIGHT = [40, 25, 25]        # 2D bbox height in px (easy, moderate, hard)
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
IOU_THRESH = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}


def clean_gt(anno, cls_name, difficulty):
    """Returns (care mask, ignored mask) over gt boxes for one frame."""
    names = np.asarray(anno["name"])
    n = len(names)
    care = np.zeros(n, bool)
    ignored = np.zeros(n, bool)
    occl = np.asarray(anno.get("occluded", np.zeros(n)))
    trunc = np.asarray(anno.get("truncated", np.zeros(n)))
    bbox = np.asarray(anno.get("bbox", np.zeros((n, 4))))
    heights = bbox[:, 3] - bbox[:, 1] if len(bbox) else np.zeros(n)
    for i in range(n):
        same = names[i] == cls_name
        neighbor = (
            (cls_name == "Pedestrian" and names[i] == "Person_sitting")
            or (cls_name == "Car" and names[i] == "Van")
        )
        too_hard = (
            occl[i] > MAX_OCCLUSION[difficulty]
            or trunc[i] > MAX_TRUNCATION[difficulty]
            or (len(bbox) and heights[i] < MIN_HEIGHT[difficulty])
        )
        if same and not too_hard:
            care[i] = True
        elif same or neighbor or names[i] == "DontCare":
            ignored[i] = True
    return care, ignored


def _ap_curve(scores_tp, num_gt, recall_points, use_sim=False):
    """scores_tp: list of (score, is_tp[, sim]); interpolated AP over the
    given recall sample points. With use_sim the numerator is the cumulative
    orientation similarity of TPs (AOS)."""
    if num_gt == 0 or not scores_tp:
        return 0.0
    arr = np.asarray(scores_tp)
    order = np.argsort(-arr[:, 0])
    tp = arr[order, 1]
    num = arr[order, 2] * tp if (use_sim and arr.shape[1] > 2) else tp
    cum_tp = np.cumsum(tp)
    cum_num = np.cumsum(num)
    cum_fp = np.cumsum(1 - tp)
    recall = cum_tp / num_gt
    precision = cum_num / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    ap = 0.0
    for r in recall_points:
        idx = np.searchsorted(recall, r, side="left")
        ap += precision[idx] if idx < len(precision) else 0.0
    return ap / len(recall_points)


R40_POINTS = np.linspace(1 / 40, 1.0, 40)
# official R11 samples recall 0.0, 0.1, ..., 1.0
R11_POINTS = np.linspace(0.0, 1.0, 11)


def _ap_r40(scores_tp, num_gt):
    return _ap_curve(scores_tp, num_gt, R40_POINTS)


def _ap_r11(scores_tp, num_gt):
    return _ap_curve(scores_tp, num_gt, R11_POINTS)


def _boxes_2d_iou_np(a, b):
    """(N, 4), (M, 4) xyxy image boxes -> (N, M) IoU."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), 0, None)
    area_b = np.clip((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def eval_class(gt_annos, det_annos, cls_name, difficulty, metric="3d",
               compute_aos=False):
    """Matching pass for one (class, difficulty). gt_annos: per-frame dicts
    with name/gt_boxes_lidar(+bbox/occluded/truncated/alpha); det_annos:
    per-frame boxes/scores arrays + name list (and bbox/alpha for the
    'bbox'/AOS metrics). Returns (scores_tp list, num_gt)."""
    thresh = IOU_THRESH.get(cls_name, 0.5)
    scores_tp = []
    num_gt_total = 0
    for gt, det in zip(gt_annos, det_annos):
        care, ignored = clean_gt(gt, cls_name, difficulty)
        det_names = np.asarray(det.get("name", []))
        if len(det_names):
            det_mask = det_names == cls_name
        else:
            det_mask = np.ones(len(det.get("boxes", [])), bool)
        det_scores = np.asarray(det.get("scores", np.zeros(0)))[det_mask]
        num_gt_total += int(care.sum())

        if metric == "bbox":
            gt_boxes = np.asarray(gt.get("bbox", np.zeros((0, 4))))
            det_boxes = np.asarray(
                det.get("bbox", np.zeros((0, 4))))[det_mask]
        else:
            gt_boxes = np.asarray(gt.get("gt_boxes_lidar", np.zeros((0, 7))))
            det_boxes = np.asarray(
                det.get("boxes", np.zeros((0, 7))))[det_mask][:, :7]
        if compute_aos:
            gt_alpha = np.asarray(gt.get("alpha", np.zeros(len(gt_boxes))))
            det_alpha = np.asarray(
                det.get("alpha", np.zeros(int(det_mask.sum()))))[
                    : len(det_boxes)]
        if len(det_boxes) == 0:
            continue
        if len(gt_boxes) == 0:
            scores_tp.extend((s, 0, 0.0) for s in det_scores)
            continue
        if metric == "bbox":
            iou = _boxes_2d_iou_np(det_boxes.astype(np.float64),
                                   gt_boxes.astype(np.float64))
        else:
            iou_fn = boxes_iou3d if metric == "3d" else boxes_iou_bev
            iou = iou_fn(torch.from_numpy(det_boxes.astype(np.float32)),
                         torch.from_numpy(gt_boxes.astype(np.float32))
                         ).numpy()
        order = np.argsort(-det_scores)
        assigned = np.zeros(len(gt_boxes), bool)
        for di in order:
            row = iou[di].copy()
            row[assigned] = -1
            # prefer care gts (official protocol: a detection overlapping
            # both an ignored gt and a qualifying care gt counts as TP for
            # the care gt, never absorbed by the ignored one)
            care_row = np.where(care, row, -1.0)
            gi = int(np.argmax(care_row))
            if care_row[gi] >= thresh:
                assigned[gi] = True
                sim = 0.0
                if compute_aos:
                    sim = (1.0 + np.cos(gt_alpha[gi] - det_alpha[di])) / 2.0
                scores_tp.append((det_scores[di], 1, sim))
                continue
            ign_row = np.where(ignored, row, -1.0)
            gi = int(np.argmax(ign_row))
            if ign_row[gi] >= thresh:
                assigned[gi] = True  # matched an ignored gt: neither TP nor FP
            else:
                scores_tp.append((det_scores[di], 0, 0.0))
    return scores_tp, num_gt_total


def kitti_eval(gt_annos, det_annos, class_names, metrics=("bev", "3d"),
               compute_aos=None):
    """Returns (result_str, result_dict) with AP_R40 and AP_R11 per
    class x metric x difficulty, plus AOS when 2D boxes + alphas are present
    (both recall samplings)."""
    if compute_aos is None:
        compute_aos = any(
            len(np.asarray(d.get("bbox", []))) and "alpha" in d
            for d in det_annos
        )
    result = {}
    metrics = tuple(metrics) + (("bbox",) if compute_aos else ())
    for cls_name in class_names:
        for metric in metrics:
            aos = compute_aos and metric == "bbox"
            for d, dname in enumerate(["easy", "moderate", "hard"]):
                scores_tp, num_gt = eval_class(
                    gt_annos, det_annos, cls_name, d, metric,
                    compute_aos=aos)
                result[f"{cls_name}_{metric}_{dname}_R40"] = \
                    _ap_r40(scores_tp, num_gt) * 100.0
                result[f"{cls_name}_{metric}_{dname}_R11"] = \
                    _ap_r11(scores_tp, num_gt) * 100.0
                if aos:
                    result[f"{cls_name}_aos_{dname}_R40"] = _ap_curve(
                        scores_tp, num_gt, R40_POINTS, use_sim=True) * 100.0
                    result[f"{cls_name}_aos_{dname}_R11"] = _ap_curve(
                        scores_tp, num_gt, R11_POINTS, use_sim=True) * 100.0
    lines = [f"{k}: {v:.2f}" for k, v in result.items()]
    moderate_3d = [
        result.get(f"{c}_3d_moderate_R40", 0.0) for c in class_names
    ]
    result["mAP_3d_moderate_R40"] = float(np.mean(moderate_3d))
    lines.append(f"mAP_3d_moderate_R40: {result['mAP_3d_moderate_R40']:.2f}")
    return "\n".join(lines), result
