"""Detection evaluation: per-class center-distance AP with known / unknown
bucketing — port of findnpropagate_tpu/datasets/eval_utils.py (numpy).

`class_ap` matches detections to ground truths greedily by descending
score within a BEV centre distance and integrates the 101-point
interpolated precision (nuScenes style); `simple_map_eval` averages it over
the distance thresholds per class and adds mAP, mAR and, given the known
classes, AP_B (known), AP_N and AR_N (novel), the open-vocabulary
metrics.
"""

from __future__ import annotations

import numpy as np


def _center_dist_matches(det_boxes, gt_boxes, thresh):
    """(D, 7), (G, 7): match by BEV center distance <= thresh."""
    d = np.linalg.norm(
        det_boxes[:, None, :2] - gt_boxes[None, :, :2], axis=-1
    )
    return d <= thresh


def _ap_from_pr(recall, precision):
    """nuScenes-style 101-point interpolated AP."""
    if len(recall) == 0:
        return 0.0
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    grid = np.linspace(0, 1, 101)
    interp = np.interp(grid, r, p)
    return float(interp.mean())


def class_ap(dets, gts, dist_thresh=2.0):
    """dets: list per frame of dict(boxes (D,7), scores (D,)); gts: list per
    frame of (G, 7) arrays. Greedy matching by descending score."""
    all_scores = []
    all_tp = []
    num_gt = sum(len(g) for g in gts)
    for det, gt in zip(dets, gts):
        boxes, scores = det["boxes"], det["scores"]
        order = np.argsort(-scores)
        matched = np.zeros(len(gt), dtype=bool)
        for i in order:
            all_scores.append(scores[i])
            if len(gt) == 0:
                all_tp.append(0)
                continue
            d = np.linalg.norm(boxes[i, :2] - gt[:, :2], axis=-1)
            d[matched] = np.inf
            j = int(np.argmin(d))
            if d[j] <= dist_thresh:
                matched[j] = True
                all_tp.append(1)
            else:
                all_tp.append(0)
    if num_gt == 0 or len(all_scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(all_scores))
    tp = np.asarray(all_tp)[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1 - tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    return _ap_from_pr(recall, precision)


def class_recall(dets, gts, dist_thresh=2.0):
    num_gt = sum(len(g) for g in gts)
    if num_gt == 0:
        return 0.0
    hit = 0
    for det, gt in zip(dets, gts):
        if len(gt) == 0:
            continue
        boxes = det["boxes"]
        if len(boxes) == 0:
            continue
        d = np.linalg.norm(gt[:, None, :2] - boxes[None, :, :2], axis=-1)
        hit += int((d.min(axis=1) <= dist_thresh).sum())
    return hit / num_gt


def simple_map_eval(det_annos, gt_annos, class_names, known_classes=None,
                    dist_threshs=(0.5, 1.0, 2.0, 4.0)):
    """det_annos: per-frame {boxes (D, 7+), scores (D,), labels (D,) 1-idx}.
    gt_annos: per-frame {gt_boxes (G, 7+), gt_names (G,)}.

    Returns (result_str, result_dict) with per-class AP (mean over distance
    thresholds, nuScenes-style), mAP, AR, and AP_B/AP_N/AR_N when
    known_classes is given (the open-vocabulary metrics).
    """
    result = {}
    aps = {}
    ars = {}
    for ci, name in enumerate(class_names):
        dets = []
        gts = []
        for d, g in zip(det_annos, gt_annos):
            m = d["labels"] == ci + 1
            dets.append({"boxes": d["boxes"][m][:, :7], "scores": d["scores"][m]})
            gnames = np.asarray(g["gt_names"])
            gm = gnames == name
            gts.append(np.asarray(g["gt_boxes"])[gm][:, :7]
                       if len(gnames) else np.zeros((0, 7)))
        ap_t = [class_ap(dets, gts, t) for t in dist_threshs]
        aps[name] = float(np.mean(ap_t))
        ars[name] = class_recall(dets, gts, 2.0)
        result[f"AP_{name}"] = aps[name]
        result[f"AR_{name}"] = ars[name]

    result["mAP"] = float(np.mean(list(aps.values()))) if aps else 0.0
    result["mAR"] = float(np.mean(list(ars.values()))) if ars else 0.0

    if known_classes:
        known = [n for n in class_names if n in known_classes]
        novel = [n for n in class_names if n not in known_classes]
        if known:
            result["AP_B"] = float(np.mean([aps[n] for n in known]))
        if novel:
            result["AP_N"] = float(np.mean([aps[n] for n in novel]))
            result["AR_N"] = float(np.mean([ars[n] for n in novel]))

    lines = [f"{k}: {v:.4f}" for k, v in sorted(result.items())]
    return "\n".join(lines), result
