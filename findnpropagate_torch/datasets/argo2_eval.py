"""Argoverse-2 competition detection metric without the devkit.

Port of findnpropagate_tpu/datasets/argo2_eval.py (numpy): the protocol
of the av2 devkit's `evaluation.detection.eval.evaluate` with its default
`DetectionCfg`:

  * Matching affinity: 3D EUCLIDEAN CENTER DISTANCE, greedy per category in
    descending score order, one GT per detection.
  * AP: computed at affinity thresholds (0.5, 1.0, 2.0, 4.0) m and averaged;
    precision is envelope-interpolated and sampled at 100 recall points
    (av2 `compute_average_precision` semantics).
  * True-positive errors at the 2.0 m threshold:
      ATE  — translation error (3D center distance, meters)
      ASE  — scale error, 1 - IoU of the center/yaw-aligned boxes
             (= 1 - prod(min(dim)/max(dim)))
      AOE  — orientation error, smallest absolute yaw diff in [0, pi]
    Categories with no true positives take the maximum errors
    (2.0 m / 1.0 / pi), matching av2's "no TP -> max error" convention.
  * CDS (Composite Detection Score) per category:
      CDS = AP * mean(1 - err/err_max) over the three normalized errors
    with normalizers (tp_threshold=2.0, 1.0, pi). mCDS/mAP average over
    categories that have ground truth.
  * GT cuboids outside `max_range_m` (default 200, av2 DetectionCfg) or with
    zero interior lidar points (when `num_points_in_gt` is available) are
    excluded, as the devkit does.

Anno format (same as the rest of this package): per-frame dicts with
`boxes` (N, 7+) [x y z dx dy dz yaw ...], `scores`, `name`; GT dicts with
`gt_boxes` (M, 7), `gt_names`, optional `num_points_in_gt`.
"""

from __future__ import annotations

import numpy as np

AFFINITY_THRESHOLDS_M = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD_M = 2.0
MAX_NORMALIZED_ERRORS = np.array([TP_THRESHOLD_M, 1.0, np.pi])
NUM_RECALL_SAMPLES = 100


def _wrap_angle(a):
    """Smallest absolute angular difference, in [0, pi]."""
    a = np.abs(a) % (2 * np.pi)
    return np.minimum(a, 2 * np.pi - a)


def _scale_error(dims_d, dims_g):
    """1 - IoU of center/yaw-aligned boxes = 1 - prod(min/max) per axis."""
    inter = np.prod(np.minimum(dims_d, dims_g))
    union = np.prod(dims_d) + np.prod(dims_g) - inter
    return 1.0 - inter / max(union, 1e-9)


def _interp_ap(recall, precision):
    """av2-style AP: precision envelope (running max from the right),
    sampled at NUM_RECALL_SAMPLES uniform recall points."""
    if len(recall) == 0:
        return 0.0
    env = np.maximum.accumulate(precision[::-1])[::-1]
    samples = np.linspace(1.0 / NUM_RECALL_SAMPLES, 1.0, NUM_RECALL_SAMPLES)
    interp = np.interp(samples, recall, env, left=env[0], right=0.0)
    # recall levels beyond the achieved max contribute zero
    interp[samples > recall[-1] + 1e-9] = 0.0
    return float(interp.mean())


def _match_category(dets, gts, thresh):
    """Greedy center-distance matching for one category across all frames.

    dets: list per frame of (boxes(N,7), scores(N,)); gts: list per frame of
    boxes(M,7). Returns (scores, is_tp, tp_pairs, num_gt) where tp_pairs is
    a list of (det_box, gt_box) for TPs.
    """
    scores_all, tp_all, pairs = [], [], []
    num_gt = 0
    for (dboxes, dscores), gboxes in zip(dets, gts):
        num_gt += len(gboxes)
        if len(dboxes) == 0:
            continue
        order = np.argsort(-dscores)
        taken = np.zeros(len(gboxes), bool)
        for di in order:
            scores_all.append(dscores[di])
            if len(gboxes) == 0:
                tp_all.append(False)
                continue
            dist = np.linalg.norm(gboxes[:, :3] - dboxes[di, :3], axis=1)
            dist[taken] = np.inf
            gi = int(np.argmin(dist))
            if dist[gi] <= thresh:
                taken[gi] = True
                tp_all.append(True)
                pairs.append((dboxes[di], gboxes[gi]))
            else:
                tp_all.append(False)
    return (np.asarray(scores_all), np.asarray(tp_all, bool), pairs, num_gt)


def _category_ap(scores, is_tp, num_gt):
    if num_gt == 0:
        return 0.0
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = is_tp[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    recall = cum_tp / num_gt
    precision = cum_tp / (np.arange(len(tp)) + 1)
    return _interp_ap(recall, precision)


def argo2_eval(gt_annos, det_annos, class_names, max_range_m: float = 200.0):
    """Returns (result_str, result_dict) with per-category AP / ATE / ASE /
    AOE / CDS plus mAP and mCDS. See module docstring for the protocol."""
    results = {}
    per_cat_ap, per_cat_cds = [], []
    for cls in class_names:
        det_per_frame, gt_per_frame = [], []
        total_gt = 0
        for gt, det in zip(gt_annos, det_annos):
            gnames = np.asarray(gt.get("gt_names", []))
            gboxes = np.asarray(gt.get("gt_boxes", np.zeros((0, 7))),
                                np.float64).reshape(-1, gt.get(
                                    "gt_boxes", np.zeros((0, 7))).shape[-1]
                                    if len(np.shape(gt.get("gt_boxes", [])))
                                    > 1 else 7)[:, :7]
            keep = gnames == cls
            if len(gboxes):
                keep = keep & (
                    np.linalg.norm(gboxes[:, :2], axis=1) <= max_range_m)
                npts = gt.get("num_points_in_gt")
                if npts is not None and len(np.asarray(npts)) == len(keep):
                    keep = keep & (np.asarray(npts) > 0)
            gt_per_frame.append(gboxes[keep] if len(gboxes) else gboxes)
            total_gt += int(keep.sum()) if len(gboxes) else 0

            dnames = np.asarray(det.get("name", []))
            dboxes = np.asarray(det.get("boxes", np.zeros((0, 7))),
                                np.float64)[:, :7] \
                if len(np.asarray(det.get("boxes", []))) else np.zeros((0, 7))
            dscores = np.asarray(det.get("scores", np.zeros(0)), np.float64)
            dkeep = dnames == cls if len(dnames) else np.zeros(
                len(dboxes), bool)
            det_per_frame.append((dboxes[dkeep], dscores[dkeep]))

        aps = []
        tp_pairs_at_tp_thresh = []
        for thresh in AFFINITY_THRESHOLDS_M:
            scores, is_tp, pairs, num_gt = _match_category(
                det_per_frame, gt_per_frame, thresh)
            aps.append(_category_ap(scores, is_tp, num_gt))
            if thresh == TP_THRESHOLD_M:
                tp_pairs_at_tp_thresh = pairs
        ap = float(np.mean(aps))

        if tp_pairs_at_tp_thresh:
            ate = float(np.mean([
                np.linalg.norm(d[:3] - g[:3])
                for d, g in tp_pairs_at_tp_thresh]))
            ase = float(np.mean([
                _scale_error(d[3:6], g[3:6])
                for d, g in tp_pairs_at_tp_thresh]))
            aoe = float(np.mean([
                _wrap_angle(d[6] - g[6]) for d, g in tp_pairs_at_tp_thresh]))
        else:  # av2: no TPs -> maximum errors
            ate, ase, aoe = TP_THRESHOLD_M, 1.0, float(np.pi)

        errs = np.array([ate, ase, aoe]) / MAX_NORMALIZED_ERRORS
        cds = ap * float(np.mean(1.0 - np.clip(errs, 0.0, 1.0)))
        results[f"{cls}_AP"] = ap
        results[f"{cls}_ATE"] = ate
        results[f"{cls}_ASE"] = ase
        results[f"{cls}_AOE"] = aoe
        results[f"{cls}_CDS"] = cds
        if total_gt > 0:
            per_cat_ap.append(ap)
            per_cat_cds.append(cds)

    results["mAP"] = float(np.mean(per_cat_ap)) if per_cat_ap else 0.0
    results["mCDS"] = float(np.mean(per_cat_cds)) if per_cat_cds else 0.0
    lines = [f"{k}: {v:.4f}" for k, v in results.items()]
    return "\n".join(lines), results
