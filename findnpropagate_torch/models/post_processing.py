"""Fixed-size final detections, the generic, the two-stage and MPPNet's
post-processing and the recall record — port of `Detections`,
`post_process`, `recall_record`, `post_process_two_stage` and
`post_process_mppnet` of findnpropagate_tpu/models/post_processing.py
:22-190."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nms import nms_bev
from ..ops.rotated_iou import boxes_iou3d


class Detections(NamedTuple):
    boxes: torch.Tensor   # (B, D, 7+C)
    scores: torch.Tensor  # (B, D)
    labels: torch.Tensor  # (B, D) int32, 1-indexed; 0 for empty slots
    count: torch.Tensor   # (B,) int32


def nms_detections(boxes, scores, labels, valid, nms_thresh, pre: int,
                   post: int):
    """Class-agnostic rotated NMS of (B, N) candidates, the invalid ones
    never selected: fixed-size Detections with zeros in the empty slots."""
    idx, num = nms_bev(boxes, scores, nms_thresh, pre_maxsize=pre,
                       post_maxsize=post, valid_mask=valid)
    good = idx >= 0
    safe = torch.clamp(idx, min=0).long()
    ob = torch.gather(boxes, 1, safe[..., None].expand(
        *safe.shape, boxes.shape[-1]))
    ob = torch.where(good[..., None], ob, torch.zeros_like(ob))
    os_ = torch.where(good, torch.gather(scores, 1, safe),
                      torch.zeros_like(scores[:, :1]))
    ol = torch.where(good, torch.gather(labels, 1, safe),
                     torch.zeros_like(labels[:, :1]))
    return Detections(ob, os_, ol.to(torch.int32), num)


def post_process(batch_cls_preds, batch_box_preds, nms_thresh,
                 score_thresh: float = 0.1, nms_pre: int = 1024,
                 nms_post: int = 256, normalized: bool = False):
    """The class-agnostic POST_PROCESSING.NMS_CONFIG path: sigmoid (unless
    `normalized`), the best class's score and 1-indexed label per box, and
    per sample rotated NMS of the boxes scored >= score_thresh.
    batch_cls_preds (B, N, C), batch_box_preds (B, N, 7+)."""
    scores_all = batch_cls_preds if normalized \
        else torch.sigmoid(batch_cls_preds)
    scores = scores_all.amax(dim=-1)
    labels = torch.argmax(scores_all, dim=-1).to(torch.int32) + 1
    return nms_detections(batch_box_preds, scores, labels,
                          scores >= score_thresh, nms_thresh, nms_pre,
                          nms_post)


def post_process_two_stage(rcnn_scores, rois, roi_labels, roi_valid,
                           nms_thresh, score_thresh: float = 0.1,
                           nms_pre: int = 1024, nms_post: int = 256):
    """The two-stage path: the second stage's sigmoid scores on the boxes
    it gives (SECONDHead: the ROIs themselves), the labels of the ROIs,
    and per sample rotated NMS of the boxes scored >= score_thresh.
    rcnn_scores (B, M, 1) logits, rois (B, M, 7+), roi_labels (B, M)
    1-indexed, roi_valid (B, M) or None."""
    scores = torch.sigmoid(rcnn_scores[..., 0])
    if roi_valid is not None:
        scores = torch.where(roi_valid, scores, torch.zeros_like(scores))
    return nms_detections(rois, scores, roi_labels, scores >= score_thresh,
                          nms_thresh, nms_pre, nms_post)


def post_process_mppnet(cls_probs, box_preds, roi_labels, roi_valid,
                        nms_thresh, score_thresh: float = 0.1,
                        nms_pre: int = 1024, nms_post: int = 256,
                        not_apply_nms_for_vel: bool = False):
    """MPPNet's path: the scores are already blended with the first
    stage's, the labels are the ROIs', and with NOT_APPLY_NMS_FOR_VEL the
    vehicles (label 1) above the threshold are kept without NMS while the
    other classes go through it. cls_probs (B, M); box_preds (B, M, 7+);
    roi_labels (B, M). The kept boxes fill nms_post slots by descending
    score.

    As in the reference, ROI 0 stays out of the NMS survivors unless NMS
    filled all its slots: the reference scatters the survivors' flags with
    its -1 padding clipped to index 0, and the padding's False, written
    last, wins."""
    scores = torch.where(roi_valid, cls_probs, torch.zeros_like(cls_probs)) \
        if roi_valid is not None else cls_probs
    above = scores >= score_thresh
    b, n = scores.shape
    is_car = roi_labels == 1
    if not_apply_nms_for_vel:
        idx, _ = nms_bev(box_preds, torch.where(is_car, torch.zeros_like(
            scores), scores), nms_thresh, pre_maxsize=nms_pre,
            post_maxsize=nms_post, valid_mask=above & ~is_car)
    else:
        idx, _ = nms_bev(box_preds, scores, nms_thresh, pre_maxsize=nms_pre,
                         post_maxsize=nms_post, valid_mask=above)
    real = idx >= 0
    keep = torch.zeros(b, n + 1, dtype=torch.bool, device=scores.device)
    keep.scatter_(1, torch.where(real, idx, n).long(), True)
    keep = keep[:, :n]
    keep[:, 0] &= real.all(dim=-1)
    if not_apply_nms_for_vel:
        keep = keep | (is_car & above)
    key = torch.where(keep, scores, torch.full_like(scores, -1.0))
    top_v, top = top_k_lower_index_first(key, min(nms_post, n))
    good = top_v > 0
    boxes = torch.gather(box_preds, 1, top[..., None].expand(
        *top.shape, box_preds.shape[-1]))
    return Detections(
        torch.where(good[..., None], boxes, torch.zeros_like(boxes)),
        torch.where(good, torch.gather(scores, 1, top),
                    torch.zeros_like(top_v)),
        torch.where(good, torch.gather(roi_labels, 1, top),
                    torch.zeros_like(top)).to(torch.int32),
        good.sum(dim=-1).to(torch.int32))


def top_k_lower_index_first(x, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    broken by the lower index first — the order `jax.lax.top_k` gives.
    `torch.topk` leaves the order of ties unspecified, so this is a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def recall_record(det_boxes, det_mask, gt_boxes, thresh_list=(0.3, 0.5, 0.7),
                  known_labels=None):
    """Recall counts of one sample (the reference's
    generate_recall_record), with the open-vocabulary known / unknown
    buckets when `known_labels` (1-indexed known class labels) is given.

    det_boxes (D, 7+) final detections, det_mask (D,), gt_boxes (M, 8)
    padded with zero rows (last column the 1-indexed label), all on one
    device. Returns {'gt': ground truths, f'recall_{t}': matched
    counts, and with known_labels 'num_known', 'num_unknown',
    f'recall_known_{t}', f'recall_unknown_{t}'} as 0-d tensors on that
    device: a ground truth counts at t when its best 3D IoU with a masked
    detection exceeds t."""
    labelled = gt_boxes.shape[-1] > 7
    gt_valid = gt_boxes[:, 7] > 0 if labelled \
        else gt_boxes.abs().sum(dim=-1) > 0
    out = {"gt": gt_valid.sum()}
    iou = boxes_iou3d(gt_boxes[:, :7], det_boxes[:, :7])
    iou = torch.where(det_mask[None, :], iou, torch.zeros_like(iou))
    best = torch.cat([iou, iou.new_zeros(len(iou), 1)], dim=1).amax(dim=1)
    best = torch.where(gt_valid, best, torch.zeros_like(best))
    for t in thresh_list:
        out[f"recall_{t}"] = (best > t).sum()
    if known_labels is not None and labelled:
        labels = gt_boxes[:, 7].to(torch.int32)
        known = torch.zeros_like(gt_valid)
        for lbl in known_labels:
            known = known | (labels == int(lbl))
        known = known & gt_valid
        unknown = gt_valid & ~known
        out["num_known"] = known.sum()
        out["num_unknown"] = unknown.sum()
        zero = torch.zeros_like(best)
        for t in thresh_list:
            out[f"recall_known_{t}"] = (torch.where(known, best, zero)
                                        > t).sum()
            out[f"recall_unknown_{t}"] = (torch.where(unknown, best, zero)
                                          > t).sum()
    return out
