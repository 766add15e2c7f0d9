"""Loss functions — port of findnpropagate_tpu/utils/losses.py (whole
file): pure functions returning unreduced losses unless noted, numerically
the reference's (and OpenPCDet's loss_utils.py)."""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import all_sum


def sigmoid_cross_entropy_with_logits(logits, targets):
    """max(x,0) - x*z + log1p(exp(-|x|))."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets, weights, gamma: float = 2.0,
                       alpha: float = 0.25):
    """logits/targets (B, A, C); weights (B, A) or (B, A, C). Returns the
    (B, A, C) weighted loss, unreduced."""
    pred_sigmoid = torch.sigmoid(logits)
    alpha_weight = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - pred_sigmoid) + (1.0 - targets) * pred_sigmoid
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    loss = focal_weight * sigmoid_cross_entropy_with_logits(logits, targets)
    if weights.ndim == loss.ndim - 1:
        weights = weights[..., None]
    return loss * weights


def smooth_l1(diff, beta: float):
    n = diff.abs()
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def _code_weighted_diff(preds, targets, code_weights):
    targets = torch.where(torch.isnan(targets), preds, targets)
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    return diff


def weighted_smooth_l1_loss(preds, targets, weights=None,
                            beta: float = 1.0 / 9.0, code_weights=None):
    """NaN targets are ignored."""
    loss = smooth_l1(_code_weighted_diff(preds, targets, code_weights), beta)
    return loss if weights is None else loss * weights[..., None]


def weighted_l1_loss(preds, targets, weights=None, code_weights=None):
    loss = _code_weighted_diff(preds, targets, code_weights).abs()
    return loss if weights is None else loss * weights[..., None]


def l1_loss(preds, targets):
    return (preds - targets).abs()


def weighted_cross_entropy_loss(logits, one_hot_targets, weights):
    """Softmax CE against one-hot targets, anchor-wise weighted; logits
    (B, A, C)."""
    ce = -(one_hot_targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    return ce * weights


def gaussian_focal_loss(pred, target, alpha: float = 2.0, gamma: float = 4.0):
    """pred a probability map, target a gaussian heatmap; positives are the
    exactly-1 pixels."""
    eps = 1e-12
    pos_weights = (target == 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - target, gamma)
    pos_loss = -torch.log(pred + eps) * torch.pow(1 - pred, alpha) \
        * pos_weights
    neg_loss = -torch.log(1 - pred + eps) * torch.pow(pred, alpha) \
        * neg_weights
    return pos_loss + neg_loss


def focal_loss_centernet(pred, target, mask=None):
    """Normalised CornerNet focal loss over a heatmap of probabilities;
    returns a scalar: -(pos + neg) / #positives, or -neg without any. The
    positives are counted over the global batch (parallel/mesh.py), so
    inside a data-parallel step this is the process's share of the loss."""
    eps = 1e-12
    pos_inds = (target == 1.0).to(pred.dtype)
    neg_inds = (target < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - target, 4)
    if mask is not None:
        m = mask.to(pred.dtype)
        pos_inds = pos_inds * m
        neg_inds = neg_inds * m
    pos_loss = torch.log(pred + eps) * torch.pow(1 - pred, 2) * pos_inds
    neg_loss = torch.log(1 - pred + eps) * torch.pow(pred, 2) \
        * neg_weights * neg_inds
    num_pos = all_sum(pos_inds.sum())      # over the global batch
    pos_sum, neg_sum = pos_loss.sum(), neg_loss.sum()
    return torch.where(num_pos > 0,
                       -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0),
                       -neg_sum)


def reg_loss_centernet(regr, gt_regr, mask):
    """Masked L1, per code dimension, normalised by #positives (of the
    global batch). regr (B, M, D); mask (B, M). Returns (D,)."""
    num = all_sum(mask.to(regr.dtype).sum())    # over the global batch
    m = mask.to(regr.dtype)[..., None] * (~torch.isnan(gt_regr)).to(
        regr.dtype)
    gt = torch.where(torch.isnan(gt_regr), torch.zeros_like(gt_regr), gt_regr)
    loss = (regr * m - gt * m).abs().sum(dim=(0, 1))
    return loss / torch.clamp(num, min=1.0)


def clip_sigmoid(x, eps: float = 1e-4):
    """TransFusion's clamped sigmoid."""
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)


def boxes_to_corners_3d(boxes):
    """(N, 7) -> (N, 8, 3) corners in the reference's template order."""
    template = torch.tensor(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
        dtype=boxes.dtype, device=boxes.device) / 2
    c = boxes[:, None, 3:6] * template[None]
    cosa = torch.cos(boxes[:, 6])[:, None]
    sina = torch.sin(boxes[:, 6])[:, None]
    x = c[..., 0] * cosa - c[..., 1] * sina
    y = c[..., 0] * sina + c[..., 1] * cosa
    return torch.stack([x, y, c[..., 2]], dim=-1) + boxes[:, None, 0:3]


def corner_loss_lidar(pred_boxes, gt_boxes):
    """Smooth-L1 of the per-corner distances to the gt box and to its
    pi-flipped twin, the smaller of the two. Returns (N,)."""
    pred_c = boxes_to_corners_3d(pred_boxes)
    gt_c = boxes_to_corners_3d(gt_boxes)
    gt_flip = gt_boxes.clone()
    gt_flip[:, 6] += math.pi
    gt_c_flip = boxes_to_corners_3d(gt_flip)
    d = torch.minimum(torch.linalg.norm(pred_c - gt_c, dim=2),
                      torch.linalg.norm(pred_c - gt_c_flip, dim=2))
    return smooth_l1(d, beta=1.0).mean(dim=1)
