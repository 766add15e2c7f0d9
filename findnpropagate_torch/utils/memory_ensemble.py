"""ST3D-style pseudo-label memory ensembles — port of findnpropagate_tpu/
utils/memory_ensemble.py.

Merge the previous round's pseudo labels ("memory", gt_infos_a) with the
current round's (gt_infos_b):

  * consistency_ensemble: IoU-match pairs, keep the more confident box
    (or a confidence-weighted blend), memory-vote away boxes that keep
    disappearing, append the boxes that newly appeared;
  * nms_ensemble: concatenate, then class-agnostic NMS, with memory voting
    for suppressed memory boxes;
  * bipartite_ensemble: an optimal 1-1 matching (scipy's
    linear_sum_assignment on -IoU) instead of the greedy argmax.

gt_infos dicts: {gt_boxes (N, 9) [box7, label, score], cls_scores,
iou_scores, memory_counter}. Host numpy; the 3D IoU is
ops/rotated_iou.py::boxes_iou3d on `device` (CUDA unless another device is
named). Unlike the reference, which writes the ignore label into its
caller's gt_boxes and the bumped counter into its caller's dict, the port
leaves its arguments as they were and returns new arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.rotated_iou import boxes_iou3d


def _iou(a, b, device):
    dev = resolve_device(device)
    return boxes_iou3d(
        torch.from_numpy(np.ascontiguousarray(a[:, :7], np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(b[:, :7], np.float32)).to(dev),
    ).cpu().numpy()


def _apply_memory_voting(infos, cfg):
    mv = cfg.get("MEMORY_VOTING", {})
    if not mv or not mv.get("ENABLED", False):
        return infos
    counter = infos["memory_counter"]
    boxes = infos["gt_boxes"].copy()
    ignore = counter >= mv.get("IGNORE_THRESH", 2)
    boxes[ignore, 7] = -1
    keep = counter < mv.get("RM_THRESH", 3)
    out = {
        "gt_boxes": boxes[keep],
        "memory_counter": counter[keep],
        "cls_scores": infos["cls_scores"][keep]
        if infos.get("cls_scores") is not None else None,
        "iou_scores": infos["iou_scores"][keep]
        if infos.get("iou_scores") is not None else None,
    }
    return out


def consistency_ensemble(gt_infos_a, gt_infos_b, cfg, device=None):
    """memory_ensemble_utils.consistency_ensemble:9-136."""
    a, b = gt_infos_a["gt_boxes"], gt_infos_b["gt_boxes"]
    if b.shape[0] == 0:
        return _apply_memory_voting(dict(
            gt_infos_a, memory_counter=gt_infos_a["memory_counter"] + 1), cfg)
    if a.shape[0] == 0:
        return dict(gt_infos_b)

    iou = _iou(a, b, device)
    ious = iou.max(axis=1)
    match_idx = iou.argmax(axis=1)
    thresh = float(cfg.get("IOU_THRESH", 0.1))

    new_boxes = a.copy()
    new_cls = None if gt_infos_a.get("cls_scores") is None \
        else gt_infos_a["cls_scores"].copy()
    new_iou_s = None if gt_infos_a.get("iou_scores") is None \
        else gt_infos_a["iou_scores"].copy()
    counter = gt_infos_a["memory_counter"].copy()

    matched = ious >= thresh
    ai = np.nonzero(matched)[0]
    bi = match_idx[ai]
    if len(ai):
        sel_a, sel_b = a[ai], b[bi]
        if cfg.get("WEIGHTED", False):
            w = sel_a[:, 8] / (sel_a[:, 8] + sel_b[:, 8] + 1e-12)
            mn = np.minimum(sel_a[:, 8], sel_b[:, 8])
            mx = np.maximum(sel_a[:, 8], sel_b[:, 8])
            new_boxes[ai, :7] = (w[:, None] * sel_a[:, :7]
                                 + (1 - w[:, None]) * sel_b[:, :7])
            new_boxes[ai, 8] = w * (mx - mn) + mn
        else:
            better_b = sel_a[:, 8] < sel_b[:, 8]
            new_boxes[ai[better_b]] = sel_b[better_b]
            if new_cls is not None:
                new_cls[ai[better_b]] = gt_infos_b["cls_scores"][bi[better_b]]
            if new_iou_s is not None:
                new_iou_s[ai[better_b]] = \
                    gt_infos_b["iou_scores"][bi[better_b]]
        counter[ai] = 0
    counter[~matched] += 1

    infos = {"gt_boxes": new_boxes, "cls_scores": new_cls,
             "iou_scores": new_iou_s, "memory_counter": counter}
    infos = _apply_memory_voting(infos, cfg)

    # newly appeared boxes in b (no memory match)
    new_b = np.nonzero(iou.max(axis=0) < thresh)[0]
    if len(new_b):
        infos["gt_boxes"] = np.concatenate(
            [infos["gt_boxes"], b[new_b]], axis=0
        )
        infos["memory_counter"] = np.concatenate(
            [infos["memory_counter"], gt_infos_b["memory_counter"][new_b]]
        )
        if infos["cls_scores"] is not None:
            infos["cls_scores"] = np.concatenate(
                [infos["cls_scores"], gt_infos_b["cls_scores"][new_b]]
            )
        if infos["iou_scores"] is not None:
            infos["iou_scores"] = np.concatenate(
                [infos["iou_scores"], gt_infos_b["iou_scores"][new_b]]
            )
    return infos


def nms_ensemble(gt_infos_a, gt_infos_b, cfg, device=None):
    """memory_ensemble_utils.nms_ensemble:137-224: concat + NMS, with memory
    voting for suppressed a-boxes."""
    a, b = gt_infos_a["gt_boxes"], gt_infos_b["gt_boxes"]
    if b.shape[0] == 0:
        return _apply_memory_voting(dict(
            gt_infos_a, memory_counter=gt_infos_a["memory_counter"] + 1), cfg)
    if a.shape[0] == 0:
        return dict(gt_infos_b)

    boxes = np.concatenate([a, b], axis=0)
    counter = np.concatenate(
        [gt_infos_a["memory_counter"], gt_infos_b["memory_counter"]]
    )
    scores = boxes[:, 8]
    iou = _iou(boxes, boxes, device)
    order = np.argsort(-scores)
    suppressed = np.zeros(len(boxes), bool)
    keep = []
    thresh = float(cfg.get("NMS_THRESH", 0.1))
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        overl = iou[i] > thresh
        overl[i] = False
        # kept box matched by the other round's box -> reset counter
        if overl.any():
            counter[i] = 0
        else:
            counter[i] += 1 if i < len(a) else 0
        suppressed |= overl
    keep = np.asarray(keep)
    infos = {
        "gt_boxes": boxes[keep],
        "memory_counter": counter[keep],
        "cls_scores": None,
        "iou_scores": None,
    }
    return _apply_memory_voting(infos, cfg)


def bipartite_ensemble(gt_infos_a, gt_infos_b, cfg, device=None):
    """memory_ensemble_utils.bipartite_ensemble:225-344: optimal 1-1 matching
    via LAP on -IoU, then the consistency merge rule."""
    from scipy.optimize import linear_sum_assignment

    a, b = gt_infos_a["gt_boxes"], gt_infos_b["gt_boxes"]
    if b.shape[0] == 0:
        return _apply_memory_voting(dict(
            gt_infos_a, memory_counter=gt_infos_a["memory_counter"] + 1), cfg)
    if a.shape[0] == 0:
        return dict(gt_infos_b)

    iou = _iou(a, b, device)
    rows, cols = linear_sum_assignment(-iou)
    thresh = float(cfg.get("IOU_THRESH", 0.1))

    new_boxes = a.copy()
    counter = gt_infos_a["memory_counter"].copy()
    matched_b = np.zeros(len(b), bool)
    matched_a = np.zeros(len(a), bool)
    for r, c in zip(rows, cols):
        if iou[r, c] >= thresh:
            matched_a[r] = True
            matched_b[c] = True
            if a[r, 8] < b[c, 8]:
                new_boxes[r] = b[c]
            counter[r] = 0
    counter[~matched_a] += 1
    infos = {"gt_boxes": new_boxes, "memory_counter": counter,
             "cls_scores": None, "iou_scores": None}
    infos = _apply_memory_voting(infos, cfg)
    new_b = np.nonzero(~matched_b)[0]
    if len(new_b):
        infos["gt_boxes"] = np.concatenate([infos["gt_boxes"], b[new_b]])
        infos["memory_counter"] = np.concatenate(
            [infos["memory_counter"], gt_infos_b["memory_counter"][new_b]]
        )
    return infos


def memory_ensemble(gt_infos_a, gt_infos_b, cfg, device=None):
    """Dispatch by cfg.NAME (memory_ensemble_utils.memory_ensemble:345)."""
    name = cfg.get("NAME", "consistency_ensemble")
    fn = {
        "consistency_ensemble": consistency_ensemble,
        "nms_ensemble": nms_ensemble,
        "bipartite_ensemble": bipartite_ensemble,
    }[name]
    return fn(gt_infos_a, gt_infos_b, cfg, device)
