"""Greedy BEV NMS — port of findnpropagate_tpu/ops/nms.py
(`_greedy_suppress`, `nms_bev`, `_iou_normal_matrix`, `nms_normal_bev`
:24-119, `class_agnostic_nms` :125, `multi_classes_nms` :142,
`circle_nms` :169).

Outputs are fixed-size, as in the reference: (indices padded with -1,
number kept). Leading batch axes broadcast, so the seeker runs one call
over all its detections' proposals. The top-k order is the reference's
`lax.top_k` order: descending score, the lower index first among equal
scores (a stable descending sort).

The greedy recurrence is a loop over rows, each step a vector operation
over the batch. Rows that overlap no later box cannot change the result,
so the loop visits only the others; finding them costs one read of the
device (a host sync) per call. With `post_maxsize == 1` no loop runs: the
best valid box in score order is never suppressed and is the only one
kept, so the result is known from the sort alone.
"""

from __future__ import annotations

import torch

from .rotated_iou import boxes_iou_bev

NEG_INF = -1e9


def _top_k(scores, k):
    """(..., N) -> (values, indices) of the k largest, `lax.top_k` order."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress(over, valid):
    """over (..., K, K) bool for boxes sorted by descending score: row i
    suppresses every later j where over[i, j], if i itself survives.
    valid (..., K). Returns the keep mask (..., K)."""
    k = over.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool, device=over.device).triu(1)
    over = over & later
    rows = over.reshape(-1, k, k).any(dim=0).any(dim=-1)
    suppressed = torch.zeros_like(valid)
    for i in torch.nonzero(rows.cpu()).flatten().tolist():
        alive = valid[..., i] & ~suppressed[..., i]
        suppressed = suppressed | (over[..., i, :] & alive[..., None])
    return valid & ~suppressed


def _greedy_suppress(iou_mat, valid, thresh):
    """iou_mat (..., K, K) for boxes sorted by descending score -> keep
    mask (..., K): row i suppresses all later j with IoU > thresh, but
    only if i itself survived."""
    return _suppress(iou_mat > thresh, valid)


def _nms(boxes, scores, thresh, pre_maxsize, post_maxsize, valid_mask,
         iou_fn):
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores,
                             torch.full_like(scores, NEG_INF))
    k = min(pre_maxsize, boxes.shape[-2])
    top_scores, order = _top_k(scores, k)
    top_valid = top_scores > NEG_INF / 2
    if post_maxsize == 1:
        keep = top_valid & (torch.arange(k, device=scores.device) == 0)
    else:
        top_boxes = torch.gather(
            boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
        keep = _greedy_suppress(iou_fn(top_boxes, top_boxes), top_valid,
                                thresh)
    keep_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, NEG_INF))
    sel_scores, sel = _top_k(keep_scores, min(post_maxsize, k))
    kept = torch.gather(order, -1, sel).to(torch.int32)
    good = sel_scores > NEG_INF / 2
    return (torch.where(good, kept, torch.full_like(kept, -1)),
            good.sum(dim=-1).to(torch.int32))


def nms_bev(boxes, scores, thresh, pre_maxsize: int = 1024,
            post_maxsize: int = 256, valid_mask=None):
    """Rotated BEV NMS (`nms_gpu` semantics). boxes (..., N, 7), scores
    (..., N), optional valid_mask (..., N): invalid boxes are never
    selected. Returns (indices (..., post) int32 padded with -1, num kept
    (...) int32)."""
    return _nms(boxes, scores, thresh, pre_maxsize, post_maxsize,
                valid_mask, boxes_iou_bev)


def _iou_normal_matrix(boxes_a, boxes_b):
    """Axis-aligned BEV IoU ignoring heading: (..., N, 7), (..., M, 7) ->
    (..., N, M)."""
    ax1 = (boxes_a[..., 0] - boxes_a[..., 3] / 2)[..., :, None]
    ax2 = (boxes_a[..., 0] + boxes_a[..., 3] / 2)[..., :, None]
    ay1 = (boxes_a[..., 1] - boxes_a[..., 4] / 2)[..., :, None]
    ay2 = (boxes_a[..., 1] + boxes_a[..., 4] / 2)[..., :, None]
    bx1 = (boxes_b[..., 0] - boxes_b[..., 3] / 2)[..., None, :]
    bx2 = (boxes_b[..., 0] + boxes_b[..., 3] / 2)[..., None, :]
    by1 = (boxes_b[..., 1] - boxes_b[..., 4] / 2)[..., None, :]
    by2 = (boxes_b[..., 1] + boxes_b[..., 4] / 2)[..., None, :]
    inter = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                        min=0.0) \
        * torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                      min=0.0)
    sa = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    sb = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return inter / torch.clamp(sa + sb - inter, min=1e-8)


def nms_normal_bev(boxes, scores, thresh, pre_maxsize: int = 1024,
                   post_maxsize: int = 256, valid_mask=None):
    """`nms_normal_gpu` semantics: greedy NMS over the axis-aligned BEV
    IoU, heading ignored. Shapes and outputs as `nms_bev`."""
    return _nms(boxes, scores, thresh, pre_maxsize, post_maxsize,
                valid_mask, _iou_normal_matrix)


def _take(x, idx):
    """x (..., N) at idx (..., K) padded with -1: 0 in the padded slots."""
    got = torch.gather(x, -1, torch.clamp(idx, min=0).long())
    return torch.where(idx >= 0, got, torch.zeros_like(got))


def class_agnostic_nms(box_scores, box_preds, nms_thresh, score_thresh=None,
                       pre_maxsize: int = 1024, post_maxsize: int = 256):
    """Rotated NMS of every box whatever its class, those scored below
    `score_thresh` never selected. Returns (indices padded with -1, their
    scores (0 in the padded slots), number kept)."""
    valid = None if score_thresh is None else box_scores >= score_thresh
    idx, num = nms_bev(box_preds, box_scores, nms_thresh,
                       pre_maxsize=pre_maxsize, post_maxsize=post_maxsize,
                       valid_mask=valid)
    return idx, _take(box_scores, idx), num


def multi_classes_nms(cls_scores, box_preds, nms_thresh, score_thresh=None,
                      pre_maxsize: int = 512, post_maxsize: int = 128):
    """One rotated NMS per class, the classes run as one batch. cls_scores
    (N, C), box_preds (N, 7+). Returns (indices (C, post) padded with -1,
    their scores (C, post), 0-indexed labels (C, post), counts (C,))."""
    scores = cls_scores.transpose(0, 1)                       # (C, N)
    boxes = box_preds.expand(scores.shape[0], *box_preds.shape)
    idx, sel_scores, num = class_agnostic_nms(
        scores, boxes, nms_thresh, score_thresh, pre_maxsize, post_maxsize)
    labels = torch.arange(scores.shape[0], device=scores.device)[:, None] \
        .expand(idx.shape)
    return idx, sel_scores, labels, num


def circle_nms(centers, scores, radius, post_maxsize: int = 83):
    """CenterPoint's circle NMS: in descending score order, a kept centre
    suppresses every later one within squared distance `radius`. centers
    (N, D), scores (N,). Returns (indices (min(post, N),) int32 padded with
    -1, number kept)."""
    n = centers.shape[0]
    top, order = _top_k(scores, n)
    c = centers[order]
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(dim=-1)
    keep = _suppress(d2 < radius, torch.ones(n, dtype=torch.bool,
                                               device=scores.device))
    keep_scores = torch.where(keep, top, torch.full_like(top, NEG_INF))
    sel_scores, sel = _top_k(keep_scores, min(post_maxsize, n))
    good = sel_scores > NEG_INF / 2
    kept = order[sel].to(torch.int32)
    return (torch.where(good, kept, torch.full_like(kept, -1)),
            good.sum().to(torch.int32))
