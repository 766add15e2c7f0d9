"""nuScenes detection evaluation (mAP, TP metrics, NDS) without the devkit —
port of findnpropagate_tpu/datasets/nuscenes_eval.py (numpy).

The `detection_cvpr_2019` protocol:

  * per-class, per-distance-threshold (0.5/1/2/4 m BEV center distance)
    greedy matching by descending confidence over the whole split;
  * 101-point interpolated precision/recall, AP = mean precision over the
    operating range with recall and precision both clamped at 0.1
    (min_recall / min_precision);
  * TP metrics at the 2 m threshold, as cumulative means interpolated onto
    the recall grid: ATE (2D center distance), ASE (1 - aligned IoU),
    AOE (yaw delta, period pi for barrier, skipped for traffic_cone),
    AVE (2D velocity L2, skipped for barrier/traffic_cone),
    AAE (1 - attribute accuracy, skipped for barrier/traffic_cone);
  * class-range filtering (e.g. car 50 m, pedestrian 40 m, cone 30 m),
    zero-point GT removal, 500-box/sample cap;
  * NDS = (5*mAP + sum_tp max(0, 1 - mTP)) / 10.

Open-vocabulary extensions: AP_B / AP_N / AR_N bucketing over known vs
novel classes, and each class's recall (`class_recall`).

Inputs are in the LIDAR frame (ego at origin), boxes (N, 7[+2]) as
[x, y, z, dx, dy, dz, heading(, vx, vy)].
"""

from __future__ import annotations

import numpy as np

DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MAX_BOXES_PER_SAMPLE = 500
NELEM = 101  # recall grid resolution

# detection_cvpr_2019 class_range
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
DEFAULT_RANGE = 50.0

TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
PRETTY_TP = {"trans_err": "mATE", "scale_err": "mASE", "orient_err": "mAOE",
             "vel_err": "mAVE", "attr_err": "mAAE"}

# most-frequent attribute per class, used when a detector provides no
# attributes
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "trailer": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "pedestrian": "pedestrian.moving", "motorcycle": "cycle.without_rider",
    "bicycle": "cycle.without_rider", "traffic_cone": "", "barrier": "",
}


def _skip_metric(metric: str, class_name: str) -> bool:
    if metric in ("vel_err", "attr_err") and class_name in (
            "barrier", "traffic_cone"):
        return True
    if metric == "orient_err" and class_name == "traffic_cone":
        return True
    return False


def angle_diff(a, b, period):
    d = (a - b) % period
    return np.minimum(d, period - d)


def scale_iou(det_box, gt_box):
    """IoU of the two boxes after aligning translation and rotation
    (pure size IoU: intersection of dims / union)."""
    sd = np.maximum(det_box[3:6], 1e-6)
    sg = np.maximum(gt_box[3:6], 1e-6)
    inter = np.prod(np.minimum(sd, sg))
    union = np.prod(sd) + np.prod(sg) - inter
    return float(inter / union)


def velocity_l2(det_box, gt_box):
    if len(det_box) < 9 or len(gt_box) < 9:
        return np.nan
    return float(np.linalg.norm(det_box[7:9] - gt_box[7:9]))


def _cummean(x):
    """Cumulative mean ignoring NaNs (devkit utils.cummean)."""
    x = np.asarray(x, np.float64)
    nan = np.isnan(x)
    if nan.all():
        return np.ones(len(x))
    v = np.where(nan, 0.0, x)
    cnt = np.cumsum(~nan)
    return np.cumsum(v) / np.maximum(cnt, 1)


def default_attribute(name, box):
    """The attribute assigned to a detection from its class and speed."""
    speed = np.linalg.norm(box[7:9]) if len(box) >= 9 else 0.0
    if speed > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    else:
        if name == "pedestrian":
            return "pedestrian.standing"
        if name == "bus":
            return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(name, "")


def _filter_frame(boxes, keep_extra, name_per_box):
    """Range filter: per-class max ego distance (lidar frame: ego at 0)."""
    if len(boxes) == 0:
        return np.zeros(0, bool)
    dist = np.linalg.norm(boxes[:, :2], axis=-1)
    rng = np.asarray([CLASS_RANGE.get(n, DEFAULT_RANGE) for n in name_per_box])
    return dist <= rng


def accumulate(gt_frames, det_frames, class_name, dist_th):
    """One (class, threshold) accumulation over the whole split.

    gt_frames: list of dicts {boxes (G,7+), names (G,), attrs optional (G,)}
    det_frames: list of dicts {boxes (D,7+), scores (D,), names (D,),
                               attrs optional (D,)}
    Returns dict(md) with interpolated precision/confidence and TP-error
    curves on the 101-point recall grid, or None if the class has no GT.
    """
    npos = 0
    pool = []  # (score, frame_idx, det_idx)
    for fi, (gt, det) in enumerate(zip(gt_frames, det_frames)):
        gmask = np.asarray(gt["names"]) == class_name
        npos += int(gmask.sum())
        dmask = np.asarray(det["names"]) == class_name
        for di in np.where(dmask)[0]:
            pool.append((float(det["scores"][di]), fi, int(di)))
    if npos == 0:
        return None
    if len(pool) == 0:
        # gt present, nothing detected: zero precision everywhere, worst
        # TP errors
        rec_interp = np.linspace(0, 1, NELEM)
        md = {"recall": rec_interp,
              "precision": np.zeros(NELEM),
              "confidence": np.zeros(NELEM)}
        for k in TP_METRICS:
            md[k] = np.ones(NELEM)
        return md
    pool.sort(key=lambda t: -t[0])

    taken = [set() for _ in gt_frames]
    tp, fp, conf = [], [], []
    match_data = {k: [] for k in TP_METRICS}
    match_conf = []
    period = np.pi if class_name == "barrier" else 2 * np.pi

    for score, fi, di in pool:
        gt = gt_frames[fi]
        det_box = np.asarray(det_frames[fi]["boxes"][di], np.float64)
        gmask = np.asarray(gt["names"]) == class_name
        gidx = np.where(gmask)[0]
        best, best_gi = np.inf, -1
        for gi in gidx:
            if gi in taken[fi]:
                continue
            d = np.linalg.norm(
                det_box[:2] - np.asarray(gt["boxes"][gi][:2], np.float64)
            )
            if d < best:
                best, best_gi = d, gi
        if best < dist_th:
            taken[fi].add(best_gi)
            tp.append(1)
            fp.append(0)
            conf.append(score)
            gt_box = np.asarray(gt["boxes"][best_gi], np.float64)
            match_data["trans_err"].append(best)
            match_data["scale_err"].append(1.0 - scale_iou(det_box, gt_box))
            match_data["orient_err"].append(
                float(angle_diff(det_box[6], gt_box[6], period))
            )
            match_data["vel_err"].append(velocity_l2(det_box, gt_box))
            det_attr = None
            if "attrs" in det_frames[fi] and det_frames[fi]["attrs"] is not None:
                det_attr = det_frames[fi]["attrs"][di]
            if det_attr is None:
                det_attr = default_attribute(class_name, det_box)
            gt_attr = None
            if "attrs" in gt and gt["attrs"] is not None:
                gt_attr = gt["attrs"][best_gi]
            if gt_attr is None or gt_attr == "":
                match_data["attr_err"].append(np.nan)
            else:
                match_data["attr_err"].append(
                    0.0 if det_attr == gt_attr else 1.0
                )
            match_conf.append(score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(score)

    if len(match_conf) == 0:
        # no matches at all: AP contribution comes out 0 through the clamps
        match_conf = [1.0]
        for k in TP_METRICS:
            match_data[k] = [1.0]

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    conf = np.asarray(conf, np.float64)
    prec = tp / np.maximum(tp + fp, 1e-9)
    rec = tp / npos
    rec_interp = np.linspace(0, 1, NELEM)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    md = {"recall": rec_interp, "precision": prec_i, "confidence": conf_i}
    for k in TP_METRICS:
        tmp = _cummean(np.asarray(match_data[k]))
        # interpolate against confidence, descending (devkit accumulate)
        md[k] = np.interp(conf_i[::-1], np.asarray(match_conf)[::-1],
                          tmp[::-1])[::-1]
    return md


def calc_ap(md) -> float:
    first = round(100 * MIN_RECALL) + 1
    prec = md["precision"][first:].copy()
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def calc_tp(md, metric_name) -> float:
    first = round(100 * MIN_RECALL) + 1
    nz = np.nonzero(md["confidence"])[0]
    last = int(nz[-1]) if len(nz) else 0
    if last < first:
        return 1.0
    return float(np.mean(md[metric_name][first:last + 1]))


def _prepare_frames(det_annos, gt_annos, class_names):
    """Apply the protocol filters and normalize the anno format."""
    gt_frames, det_frames = [], []
    for det, gt in zip(det_annos, gt_annos):
        gnames = np.asarray(gt.get("gt_names", []), dtype=object)
        gboxes = np.asarray(gt.get("gt_boxes", np.zeros((0, 7))), np.float64)
        if gboxes.ndim == 1:
            gboxes = gboxes.reshape(0, 7)
        gattrs = gt.get("gt_attrs", None)
        keep = np.ones(len(gnames), bool)
        if len(gnames):
            keep &= _filter_frame(gboxes, None, gnames)
            npts = gt.get("num_lidar_pts", None)
            if npts is not None:
                keep &= np.asarray(npts) > 0
        gt_frames.append({
            "boxes": gboxes[keep],
            "names": gnames[keep] if len(gnames) else gnames,
            "attrs": (np.asarray(gattrs, dtype=object)[keep]
                      if gattrs is not None else None),
        })

        dboxes = np.asarray(det.get("boxes", np.zeros((0, 7))), np.float64)
        if dboxes.ndim == 1:
            dboxes = dboxes.reshape(0, 7)
        dscores = np.asarray(det.get("scores", np.zeros(0)), np.float64)
        if "names" in det:
            dnames = np.asarray(det["names"], dtype=object)
        else:
            labels = np.asarray(det.get("labels", np.zeros(0)), np.int64)
            dnames = np.asarray(
                [class_names[l - 1] if 1 <= l <= len(class_names) else ""
                 for l in labels], dtype=object)
        dattrs = det.get("attrs", None)
        if len(dboxes) > MAX_BOXES_PER_SAMPLE:
            top = np.argsort(-dscores)[:MAX_BOXES_PER_SAMPLE]
            dboxes, dscores, dnames = dboxes[top], dscores[top], dnames[top]
            if dattrs is not None:
                dattrs = np.asarray(dattrs, dtype=object)[top]
        keep = _filter_frame(dboxes, None, dnames) if len(dboxes) else \
            np.zeros(0, bool)
        det_frames.append({
            "boxes": dboxes[keep],
            "scores": dscores[keep],
            "names": dnames[keep] if len(dnames) else dnames,
            "attrs": (np.asarray(dattrs, dtype=object)[keep]
                      if dattrs is not None else None),
        })
    return gt_frames, det_frames


def class_recall(det_frames, gt_frames, class_name, dist_th=2.0):
    """Plain recall at dist_th (for the README's AR_N column)."""
    num_gt, hit = 0, 0
    for det, gt in zip(det_frames, gt_frames):
        gmask = np.asarray(gt["names"]) == class_name
        g = gt["boxes"][gmask]
        num_gt += len(g)
        if len(g) == 0:
            continue
        dmask = np.asarray(det["names"]) == class_name
        d = det["boxes"][dmask]
        if len(d) == 0:
            continue
        dd = np.linalg.norm(g[:, None, :2] - d[None, :, :2], axis=-1)
        hit += int((dd.min(axis=1) <= dist_th).sum())
    return hit / num_gt if num_gt else 0.0


def nuscenes_protocol_eval(det_annos, gt_annos, class_names,
                           known_classes=None):
    """Full-protocol evaluation.

    det_annos: per-frame {boxes (D, 7|9), scores (D,), labels (D,) 1-indexed
               or names (D,), attrs optional}.
    gt_annos: per-frame {gt_boxes (G, 7|9), gt_names (G,), gt_attrs optional,
              num_lidar_pts optional}.

    Returns (result_str, result_dict) with per-class APs, mATE/mASE/mAOE/
    mAVE/mAAE, mAP, NDS and — when known_classes is given — AP_B/AP_N/AR_N.
    """
    gt_frames, det_frames = _prepare_frames(det_annos, gt_annos, class_names)

    label_aps = {}
    label_tps = {}
    recalls = {}
    for name in class_names:
        mds = {th: accumulate(gt_frames, det_frames, name, th)
               for th in DIST_THS}
        label_aps[name] = {
            th: (calc_ap(md) if md is not None else np.nan)
            for th, md in mds.items()
        }
        md_tp = mds[DIST_TH_TP]
        label_tps[name] = {}
        for metric in TP_METRICS:
            if _skip_metric(metric, name):
                label_tps[name][metric] = np.nan
            elif md_tp is None:
                label_tps[name][metric] = np.nan
            else:
                label_tps[name][metric] = calc_tp(md_tp, metric)
        recalls[name] = class_recall(det_frames, gt_frames, name)

    mean_dist_aps = {
        n: float(np.nanmean(list(label_aps[n].values())))
        if not np.all(np.isnan(list(label_aps[n].values()))) else 0.0
        for n in class_names
    }
    present = [n for n in class_names
               if not np.all(np.isnan(list(label_aps[n].values())))]
    mean_ap = float(np.mean([mean_dist_aps[n] for n in present])) \
        if present else 0.0

    tp_errors = {}
    for metric in TP_METRICS:
        vals = [label_tps[n][metric] for n in present
                if not _skip_metric(metric, n)
                and not np.isnan(label_tps[n][metric])]
        tp_errors[PRETTY_TP[metric]] = float(np.mean(vals)) if vals else 1.0

    nds = (5.0 * mean_ap + sum(
        max(0.0, 1.0 - tp_errors[PRETTY_TP[m]]) for m in TP_METRICS
    )) / 10.0

    result = {}
    lines = ["----------------nuScenes protocol results-----------------"]
    for n in class_names:
        aps = label_aps[n]
        errs = label_tps[n]
        lines.append(
            f"***{n} "
            + " ".join(f"AP@{th}={aps[th]*100 if not np.isnan(aps[th]) else float('nan'):.2f}"
                       for th in DIST_THS)
            + f" | meanAP: {mean_dist_aps[n]*100:.2f}"
            + " | " + " ".join(
                f"{PRETTY_TP[m]}={errs[m]:.3f}" for m in TP_METRICS
                if not np.isnan(errs[m]))
        )
        result[f"AP_{n}"] = mean_dist_aps[n]
        result[f"AR_{n}"] = recalls[n]
    lines.append("--------------average performance-------------")
    for k, v in tp_errors.items():
        lines.append(f"{k}:\t {v:.4f}")
        result[k] = v
    result["mAP"] = mean_ap
    result["NDS"] = nds
    lines.append(f"mAP:\t {mean_ap:.4f}")
    lines.append(f"NDS:\t {nds:.4f}")

    if known_classes:
        known = [n for n in class_names if n in known_classes]
        novel = [n for n in class_names if n not in known_classes]
        if known:
            result["AP_B"] = float(np.mean([mean_dist_aps[n] for n in known]))
            lines.append(f"AP_B:\t {result['AP_B']:.4f}")
        if novel:
            result["AP_N"] = float(np.mean([mean_dist_aps[n] for n in novel]))
            result["AR_N"] = float(np.mean([recalls[n] for n in novel]))
            lines.append(f"AP_N:\t {result['AP_N']:.4f}")
            lines.append(f"AR_N:\t {result['AR_N']:.4f}")

    return "\n".join(lines), result
