"""Fixed-size final detections and the recall record — port of
`Detections` and `recall_record` of findnpropagate_tpu/models/
post_processing.py:22-31, 67-105."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.rotated_iou import boxes_iou3d


class Detections(NamedTuple):
    boxes: torch.Tensor   # (B, D, 7+C)
    scores: torch.Tensor  # (B, D)
    labels: torch.Tensor  # (B, D) int32, 1-indexed; 0 for empty slots
    count: torch.Tensor   # (B,) int32


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
