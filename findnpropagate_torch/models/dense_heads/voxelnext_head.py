"""VoxelNeXtHead, the fully sparse CenterPoint-style head — port of
findnpropagate_tpu/models/dense_heads/voxelnext_head.py (`SparseSeparateHead`
:56-116, `VoxelNeXtHead` :119-173, `_bev_aligned_diou` :176,
`VoxelNeXtHeadTools` :207-599, `make_voxelnext_head_tools` :602).

Per CLASS_NAMES_EACH_HEAD group a SparseSeparateHead over the backbone's
sorted BEV list ``encoded_sparse_bev``: per output, (num_conv - 1)
submanifold (1, K, K) convs + masked BN + ReLU and a final linear layer,
zero at the invalid rows. A K = 1 conv is a per-row product; K = 3 runs the
reference's XLA windowed conv (`sparse_ops.windowed_conv`, the head's
WINDOWED_BLOCK / WINDOWED_WINDOW), plain PyTorch as in the reference, its
overflow added to the backbone's.

Targets (`assign`): each ground truth goes to its nearest active voxel
(squared distance in feature-map units, ties to the first voxel, as
jnp.argmin), the heatmap is the larger of the gaussians around the box
centre and around that voxel (GAUSSIAN_TYPE), drawn on the active voxels
and max-reduced per class. Loss: CenterNet focal loss over the active
voxels plus the masked L1 of the regression at the assigned voxels (a
velocity head over 7-value boxes, as the data layer gives them, leaves
its columns out, as CenterHead does); with
IOU_BRANCH also the L1 of the iou head against 2 * IoU3D(pred, gt) - 1 and
the axis-aligned 3D DIoU regression term. Decode (`get_bboxes`): per group
and sample the top MAX_OBJ_PER_SAMPLE (voxel, class) scores (ties to the
lower index), the score and range filter, then class-agnostic rotated NMS,
or with IOU_BRANCH the RECTIFIER score s^(1-r) * iou^r and per-class NMS
with the per-class NMS_THRESH / NMS_PRE_MAXSIZE / NMS_POST_MAXSIZE lists;
with DOUBLE_FLIP the four flipped copies of each sample merged first
(`_merge_double_flip`). The reference's vmapped per-sample functions are
written over the whole batch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import nms_bev
from ...ops.rotated_iou import boxes_aligned_iou3d
from ...ops.sparse_ops import (
    bev_merge,
    windowed_conv,
    yxz_offset_deltas,
    yxz_sentinel_start,
)
from ...utils import losses as L
from ..backbones_3d.spconv_backbone import SparseConvParam
from ..blocks import MaskedBatchNorm
from ..model_utils.centernet import gaussian_radius
from ..post_processing import Detections, top_k_lower_index_first

BIG = 1e12


class SparseSeparateHead(nn.Module):
    """Per output name: (num_conv - 1) x [(1, K, K) sparse conv, masked BN,
    ReLU] (``{name}_conv{i}``, ``{name}_bn{i}``), then ``{name}_out``."""

    def __init__(self, head_dict, head_channels, kernel_size=3,
                 use_bias=False):
        super().__init__()
        self.kernel_size = int(kernel_size)
        self.spec = {k: (int(v["out_channels"]), int(v["num_conv"]))
                     for k, v in head_dict.items()}
        c = head_channels
        for name, (out_c, n_conv) in self.spec.items():
            for i in range(n_conv - 1):
                self.add_module(f"{name}_conv{i}", SparseConvParam(
                    c, c, kernel=(1, self.kernel_size, self.kernel_size),
                    use_bias=use_bias))
                self.add_module(f"{name}_bn{i}", MaskedBatchNorm(c))
            self.add_module(f"{name}_out", nn.Linear(c, out_c))

    def forward(self, ids, feats, valid, shape2d, block, window):
        k = self.kernel_size
        deltas = yxz_offset_deltas((1, k, k), shape2d)
        sent = yxz_sentinel_start(shape2d)
        out, ovf = {}, []
        for name, (_, n_conv) in self.spec.items():
            x = feats
            for i in range(n_conv - 1):
                conv = getattr(self, f"{name}_conv{i}")
                if k == 1:
                    y = x @ conv.kernel[0]
                else:
                    y, o = windowed_conv(ids, x, ids, conv.kernel, deltas,
                                         block=block, window=window,
                                         sentinel_start=sent)
                    ovf.append(o.sum())
                if conv.bias is not None:
                    y = y + conv.bias
                y = torch.where(valid[..., None], y, torch.zeros_like(y))
                x = torch.relu(getattr(self, f"{name}_bn{i}")(
                    y, valid, channels_last=True))
            y = getattr(self, f"{name}_out")(x)
            out[name] = torch.where(valid[..., None], y, torch.zeros_like(y))
        return out, ovf


def bev_aligned_diou(pred, gt):
    """Axis-aligned 3D DIoU (yaw ignored), pred / gt (..., 7) -> (...) in
    [-1, 1]."""
    pc, gc = pred[..., :2], gt[..., :2]
    pd, gd = pred[..., 3:5], gt[..., 3:5]
    pmin, pmax = pc - 0.5 * pd, pc + 0.5 * pd
    gmin, gmax = gc - 0.5 * gd, gc + 0.5 * gd
    inter_xy = torch.clamp(torch.minimum(pmax, gmax)
                           - torch.maximum(pmin, gmin), min=0.0)
    outer_xy = torch.clamp(torch.maximum(pmax, gmax)
                           - torch.minimum(pmin, gmin), min=0.0)
    ph, gh = pred[..., 5], gt[..., 5]
    pz, gz = pred[..., 2], gt[..., 2]
    inter_h = torch.clamp(torch.minimum(pz + 0.5 * ph, gz + 0.5 * gh)
                          - torch.maximum(pz - 0.5 * ph, gz - 0.5 * gh),
                          min=0.0)
    outer_h = torch.clamp(torch.maximum(pz + 0.5 * ph, gz + 0.5 * gh)
                          - torch.minimum(pz - 0.5 * ph, gz - 0.5 * gh),
                          min=0.0)
    vol_i = inter_xy[..., 0] * inter_xy[..., 1] * inter_h
    vol_u = (pred[..., 3] * pred[..., 4] * ph
             + gt[..., 3] * gt[..., 4] * gh - vol_i)
    inter_diag = ((gt[..., :3] - pred[..., :3]) ** 2).sum(-1)
    outer_diag = outer_xy[..., 0] ** 2 + outer_xy[..., 1] ** 2 + outer_h ** 2
    diou = vol_i / torch.clamp(vol_u, min=1e-6) \
        - inter_diag / torch.clamp(outer_diag, min=1e-6)
    return torch.clamp(diou, -1.0, 1.0)


def _take(x, idx):
    """x (B, N, C), idx (B, K) -> (B, K, C)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(
        -1, -1, x.shape[-1]))


def _per_class(val, i):
    return val[i] if isinstance(val, (list, tuple)) else val


class VoxelNeXtHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 point_cloud_range, voxel_size, grid_size):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_classes = int(num_class)
        self.class_names = tuple(class_names)
        self.grid_size = tuple(int(g) for g in grid_size)   # (nx, ny, nz)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        names = list(self.class_names)
        groups = cfg.get("CLASS_NAMES_EACH_HEAD") or [names]
        self.group_labels = tuple(
            tuple(names.index(n) + 1 for n in g) for g in groups) \
            if cfg.get("CLASS_NAMES_EACH_HEAD") \
            else (tuple(range(1, self.num_classes + 1)),)
        self.stride = int(cfg["TARGET_ASSIGNER_CONFIG"]["FEATURE_MAP_STRIDE"])
        self.head_order = list(cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"])
        self.iou_branch = bool(cfg.get("IOU_BRANCH", False))
        for gi, group in enumerate(groups):
            hd = dict(cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"])
            hd["hm"] = {"out_channels": len(group),
                        "num_conv": int(cfg.get("NUM_HM_CONV", 2))}
            self.add_module(f"group{gi}", SparseSeparateHead(
                hd, int(cfg.get("SHARED_CONV_CHANNEL", input_channels)),
                kernel_size=int(cfg.get("KERNEL_SIZE_HEAD", 3)),
                use_bias=bool(cfg.get("USE_BIAS_BEFORE_NORM", False))))
        self.n_groups = len(groups)
        hm_bias = -2.19                   # the reference's hm init bias
        for gi in range(self.n_groups):
            nn.init.constant_(getattr(self, f"group{gi}").hm_out.bias,
                              hm_bias)

    def forward(self, batch, generator=None):
        bev = batch["encoded_sparse_bev"]
        shape2d = (1,) + tuple(batch["encoded_sparse_bev_shape"])
        block = int(self.model_cfg.get("WINDOWED_BLOCK", 640))
        window = int(self.model_cfg.get("WINDOWED_WINDOW", 1024))
        if bev["ids"].shape[1] % block:
            raise ValueError("the head's WINDOWED_BLOCK must divide the "
                             "backbone's padded BEV list")
        preds, ovf = [], []
        for gi in range(self.n_groups):
            p, o = getattr(self, f"group{gi}")(
                bev["ids"], bev["features"], bev["valid"], shape2d, block,
                window)
            preds.append(p)
            ovf += o
        batch["voxelnext_preds"] = tuple(preds)
        batch["voxelnext_voxels"] = {"coords": bev["coords"],
                                     "valid": bev["valid"]}
        if "sparse_window_overflow" in batch and ovf:
            batch["sparse_window_overflow"] = \
                batch["sparse_window_overflow"] + torch.stack(ovf).sum()
        return batch

    # ---- targets and loss ------------------------------------------------

    def _assign(self, gt_boxes, labels, gt_valid, vox_xy, vox_valid, nc):
        """Batched `_assign_single`: gt (B, M, 7+), LOCAL 0-indexed labels,
        vox_xy (B, V, 2) (x, y) in feature-map units. Returns heatmap
        (B, C, V), targets (B, M, code), inds (B, M), mask (B, M)."""
        cfg = self.model_cfg["TARGET_ASSIGNER_CONFIG"]
        ny = self.grid_size[1] // self.stride
        nx = self.grid_size[0] // self.stride
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        pcr = self.point_cloud_range
        gratio = float(self.model_cfg.get("GAUSSIAN_RATIO", 1))
        gtypes = list(self.model_cfg.get("GAUSSIAN_TYPE",
                                         ["nearst", "gt_center"]))
        cx = torch.clamp((gt_boxes[..., 0] - pcr[0]) / vx / self.stride,
                         0, nx - 0.5)
        cy = torch.clamp((gt_boxes[..., 1] - pcr[1]) / vy / self.stride,
                         0, ny - 0.5)
        dx = gt_boxes[..., 3] / vx / self.stride
        dy = gt_boxes[..., 4] / vy / self.stride
        radius = gaussian_radius(dx, dy, float(cfg.get("GAUSSIAN_OVERLAP",
                                                       0.1)))
        radius = torch.clamp(radius.to(torch.int32),
                             min=int(cfg.get("MIN_RADIUS", 2)))
        valid = gt_valid & (dx > 0) & (dy > 0)
        center = torch.stack([cx, cy], -1)                       # (B, M, 2)
        vv = vox_valid[:, None, :]
        d_gt = ((vox_xy[:, None] - center[:, :, None]) ** 2).sum(-1)
        d_gt = torch.where(vv, d_gt, torch.full_like(d_gt, BIG))  # (B,M,V)
        inds = torch.argmin(d_gt, dim=2)                         # (B, M)
        near_xy = _take(vox_xy, inds)                            # (B, M, 2)
        diam = 2 * radius.float() * gratio + 1
        sig2 = (2 * (diam / 6.0) ** 2)[..., None]
        gs = []
        if "gt_center" in gtypes:
            gs.append(torch.exp(-d_gt / sig2))
        if "nearst" in gtypes:
            d_nn = ((vox_xy[:, None] - near_xy[:, :, None]) ** 2).sum(-1)
            d_nn = torch.where(vv, d_nn, torch.full_like(d_nn, BIG))
            gs.append(torch.exp(-d_nn / sig2))
        g = torch.maximum(*gs) if len(gs) == 2 else gs[0]
        g = torch.where(valid[..., None] & vv, g, torch.zeros_like(g))
        cls = torch.clamp(labels, 0, nc - 1)
        heatmap = torch.stack([
            torch.where((cls == c)[..., None], g, torch.zeros_like(g)
                        ).amax(dim=1) for c in range(nc)], dim=1)  # (B,C,V)
        parts = [center[..., 0] - near_xy[..., 0],
                 center[..., 1] - near_xy[..., 1], gt_boxes[..., 2],
                 torch.log(torch.clamp(gt_boxes[..., 3], min=1e-5)),
                 torch.log(torch.clamp(gt_boxes[..., 4], min=1e-5)),
                 torch.log(torch.clamp(gt_boxes[..., 5], min=1e-5)),
                 torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])]
        parts += [gt_boxes[..., 7 + i] for i in range(gt_boxes.shape[-1] - 7)]
        targets = torch.stack(parts, -1)
        targets = torch.where(valid[..., None], targets,
                              torch.zeros_like(targets))
        return heatmap, targets, torch.where(valid, inds,
                                             torch.zeros_like(inds)), valid

    def assign(self, gt_boxes_with_cls, vox_xy, vox_valid, group=None):
        gt = gt_boxes_with_cls[..., :-1]
        glabels = gt_boxes_with_cls[..., -1].to(torch.int64)
        valid = glabels > 0
        if group is None:
            labels = torch.clamp(glabels - 1, min=0)
            nc = self.num_classes
        else:
            lut = torch.full((self.num_classes + 1,), -1, dtype=torch.int64,
                             device=gt.device)
            for li, gl in enumerate(group):
                lut[gl] = li
            local = lut[torch.clamp(glabels, 0, self.num_classes)]
            valid = valid & (local >= 0)
            labels = torch.clamp(local, min=0)
            nc = len(group)
        return self._assign(gt, labels, valid, vox_xy, vox_valid, nc)

    def _pred_boxes(self, g, near):
        """Boxes (..., 7) from gathered regression rows and their voxels'
        (x, y): the iou branch's decode."""
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        pcr = self.point_cloud_range
        x = (near[..., 0] + g[..., 0]) * self.stride * vx + pcr[0]
        y = (near[..., 1] + g[..., 1]) * self.stride * vy + pcr[1]
        dims = torch.exp(torch.clamp(g[..., 3:6], -6.0, 6.0))
        ang = torch.atan2(g[..., 7], g[..., 6])
        return torch.cat([x[..., None], y[..., None], g[..., 2:3], dims,
                          ang[..., None]], -1)

    def compute_loss(self, out_batch):
        preds_all = out_batch["voxelnext_preds"]
        vox = out_batch["voxelnext_voxels"]
        vox_xy = torch.stack([vox["coords"][..., 2], vox["coords"][..., 1]],
                             -1).float()
        vox_valid = vox["valid"]
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        code_w = torch.tensor(lw["code_weights"], dtype=torch.float32,
                              device=vox_xy.device)
        gt_all = out_batch["gt_boxes"]
        hm_total = loc_total = iou_total = iou_reg_total = 0.0
        for preds, group in zip(preds_all, self.group_labels):
            heatmaps, targets, inds, masks = self.assign(
                gt_all, vox_xy, vox_valid,
                group=None if len(self.group_labels) == 1 else group)
            hm_pred = torch.clamp(torch.sigmoid(preds["hm"].transpose(1, 2)),
                                  1e-4, 1 - 1e-4)            # (B, C, V)
            mask_cv = vox_valid[:, None, :].expand_as(hm_pred)
            hm_total = hm_total + L.focal_loss_centernet(
                hm_pred, heatmaps, mask=mask_cv) * float(lw["cls_weight"])
            reg = torch.cat([preds[k] for k in self.head_order], -1)
            gathered = _take(reg, inds)                      # (B, M, code)
            code = gathered.shape[-1]
            target = targets[..., :code]
            if target.shape[-1] < code:
                # boxes without velocity (the data layer keeps 7 values)
                # under a velocity head: NaN targets, which the loss leaves
                # out, as CenterHead's; the reference's shapes do not
                # broadcast there
                target = F.pad(target, (0, code - target.shape[-1]),
                               value=float("nan"))
            per_dim = L.reg_loss_centernet(gathered, target, masks)
            loc_total = loc_total + (per_dim * code_w).sum() \
                * float(lw["loc_weight"])
            if self.iou_branch:
                pred_boxes = self._pred_boxes(gathered, _take(vox_xy, inds))
                gt_raw = gt_all[..., :7]
                iou_t = 2.0 * boxes_aligned_iou3d(pred_boxes.detach(),
                                                  gt_raw) - 1.0
                iou_p = torch.gather(preds["iou"][..., 0], 1, inds.long())
                m = masks.float()
                n_fg = torch.clamp(m.sum(), min=1e-4)
                iou_total = iou_total + ((iou_p - iou_t).abs() * m).sum() \
                    / n_fg
                diou = bev_aligned_diou(pred_boxes, gt_raw)
                iou_w = float(lw.get("iou_weight", lw["loc_weight"]))
                iou_reg_total = iou_reg_total + iou_w * (
                    (1.0 - diou) * m).sum() / n_fg
        total = hm_total + loc_total + iou_total + iou_reg_total
        tb = {"hm_loss": hm_total, "loc_loss": loc_total, "rpn_loss": total}
        if self.iou_branch:
            tb["iou_loss"] = iou_total
            tb["iou_reg_loss"] = iou_reg_total
        return total, tb

    # ---- decode ----------------------------------------------------------

    def _merge_double_flip(self, preds, coords, valid):
        """Groups of four batch entries [original, y-flip, x-flip, xy-flip]
        flip their voxels and sign-sensitive channels back and average
        their coinciding BEV cells (`bev_merge` of the four copies, a count
        channel beside). Returns (preds with hm as probabilities and dim
        exponentiated, coords, valid) at batch B4 / 4."""
        ny = self.grid_size[1] // self.stride
        nx = self.grid_size[0] // self.stride
        b4, v = valid.shape
        b = b4 // 4
        vel = preds.get("vel")
        per = lambda x: x.reshape((b, 4, v) + x.shape[2:])  # noqa: E731
        hm4 = per(torch.sigmoid(preds["hm"]))
        dim4 = per(torch.exp(preds["dim"]))
        ctr4, rot4, cz4 = per(preds["center"]), per(preds["rot"]), \
            per(preds["center_z"])
        vel4 = per(vel) if vel is not None else None
        c4, v4 = per(coords), per(valid)

        def flip(x, fx, fy):
            return torch.stack([-x[..., 0] if fx else x[..., 0],
                                -x[..., 1] if fy else x[..., 1]], -1)

        cs, feats = [], []
        for i in range(4):
            fy, fx = i in (1, 3), i in (2, 3)
            c = c4[:, i]
            cs.append(torch.stack([c[..., 0], ny - c[..., 1] if fy
                                   else c[..., 1], nx - c[..., 2] if fx
                                   else c[..., 2]], -1))
            f = [hm4[:, i], flip(ctr4[:, i], fx, fy), cz4[:, i], dim4[:, i],
                 flip(rot4[:, i], fx, fy)]
            if vel4 is not None:
                f.append(flip(vel4[:, i], fx, fy))
            feats.append(torch.cat(f, -1))
        cat_f = torch.cat(feats, 1)
        cat_f = torch.cat([cat_f, cat_f.new_ones(cat_f.shape[:2] + (1,))],
                          -1)
        _, coords_m, valid_m, feats_m = bev_merge(
            [torch.cat(cs, 1)], [torch.cat([v4[:, i] for i in range(4)], 1)],
            [cat_f], (1,), (ny, nx), 2 * v)
        mean = feats_m[..., :-1] / torch.clamp(feats_m[..., -1:], min=1.0)
        names = ["hm", "center", "center_z", "dim", "rot"] \
            + (["vel"] if vel is not None else [])
        sizes = [hm4.shape[-1], 2, 1, 3, 2] + ([2] if vel is not None else [])
        out = dict(zip(names, torch.split(mean, sizes, -1)))
        return out, coords_m, valid_m

    def _one_group(self, preds, coords, valid, group, activated):
        pp = self.model_cfg["POST_PROCESSING"]
        k = int(pp.get("MAX_OBJ_PER_SAMPLE", 500))
        score_thresh = float(pp.get("SCORE_THRESH", 0.1))
        nms_cfg = pp.get("NMS_CONFIG", {})
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        pcr = self.point_cloud_range
        dev = coords.device
        post_range = torch.tensor(pp["POST_CENTER_LIMIT_RANGE"],
                                  dtype=torch.float32, device=dev)
        vxy = torch.stack([coords[..., 2], coords[..., 1]], -1).float()
        hm = preds["hm"] if activated else torch.sigmoid(preds["hm"])
        hm = torch.where(valid[..., None], hm, torch.zeros_like(hm))
        b, v, c = hm.shape
        kk = min(k, v * c)
        scores, flat = top_k_lower_index_first(hm.reshape(b, -1), kk)
        vox_idx, cls_local = flat // c, flat % c
        g = _take(torch.cat([preds[h] for h in self.head_order], -1),
                  vox_idx)
        near = _take(vxy, vox_idx)
        x = (near[..., 0] + g[..., 0]) * self.stride * vx + pcr[0]
        y = (near[..., 1] + g[..., 1]) * self.stride * vy + pcr[1]
        dims = g[..., 3:6] if activated else torch.exp(g[..., 3:6])
        ang = torch.atan2(g[..., 7], g[..., 6])
        parts = [x[..., None], y[..., None], g[..., 2:3], dims,
                 ang[..., None]]
        if "vel" in self.head_order:
            parts.append(g[..., 8:10])
        boxes = torch.cat(parts, -1)
        ok = ((scores > score_thresh)
              & (boxes[..., :3] >= post_range[:3]).all(-1)
              & (boxes[..., :3] <= post_range[3:]).all(-1)
              & torch.gather(valid, 1, vox_idx))

        def select(idx, s, label):
            good = idx >= 0
            safe = torch.clamp(idx, min=0).long()
            bx = _take(boxes, safe)
            return (torch.where(good[..., None], bx, torch.zeros_like(bx)),
                    torch.where(good, torch.gather(s, 1, safe),
                                torch.zeros_like(s[:, :1])),
                    torch.where(good, label(safe),
                                torch.zeros_like(safe)).to(torch.int32))

        if self.iou_branch:
            iou_v = (preds["iou"][..., 0] + 1.0) * 0.5
            iou_sel = torch.clamp(torch.gather(iou_v, 1, vox_idx), 0.0, 1.0)
            rect = self.model_cfg.get("RECTIFIER", [0.5] * self.num_classes)
            out, num = [], 0
            for ci, gl in enumerate(group):
                r = float(_per_class(rect, gl - 1))
                s_rect = torch.pow(torch.clamp(scores, min=1e-6), 1.0 - r) \
                    * torch.pow(torch.clamp(iou_sel, min=1e-6), r)
                ok_c = ok & (cls_local == ci)
                idx, n = nms_bev(
                    boxes, torch.where(ok_c, s_rect, torch.zeros_like(
                        s_rect)),
                    float(_per_class(nms_cfg.get("NMS_THRESH", 0.7), gl - 1)),
                    pre_maxsize=int(_per_class(nms_cfg.get(
                        "NMS_PRE_MAXSIZE", kk), gl - 1)),
                    post_maxsize=int(_per_class(nms_cfg.get(
                        "NMS_POST_MAXSIZE", 128), gl - 1)),
                    valid_mask=ok_c)
                out.append(select(idx, s_rect, lambda safe, gl=gl:
                                  torch.full_like(safe, gl)))
                num = num + n
            return tuple(torch.cat([o[j] for o in out], 1)
                         for j in range(3)) + (num,)
        idx, num = nms_bev(
            boxes, torch.where(ok, scores, torch.zeros_like(scores)),
            float(nms_cfg.get("NMS_THRESH", 0.7)),
            pre_maxsize=int(nms_cfg.get("NMS_PRE_MAXSIZE", kk)),
            post_maxsize=int(nms_cfg.get("NMS_POST_MAXSIZE", 128)),
            valid_mask=ok)
        lut = torch.tensor((0,) + tuple(group), dtype=torch.int64,
                           device=dev)
        return select(idx, scores, lambda safe: lut[torch.clamp(
            torch.gather(cls_local, 1, safe) + 1, 0, len(group))]) + (num,)

    @torch.no_grad()
    def get_bboxes(self, out_batch):
        vox = out_batch["voxelnext_voxels"]
        double_flip = bool(self.model_cfg.get("DOUBLE_FLIP", False))
        parts = []
        for preds, group in zip(out_batch["voxelnext_preds"],
                                self.group_labels):
            if double_flip:
                mp, mc, mv = self._merge_double_flip(preds, vox["coords"],
                                                     vox["valid"])
                parts.append(self._one_group(mp, mc, mv, group, True))
            else:
                parts.append(self._one_group(preds, vox["coords"],
                                             vox["valid"], group, False))
        return Detections(torch.cat([p[0] for p in parts], 1),
                          torch.cat([p[1] for p in parts], 1),
                          torch.cat([p[2] for p in parts], 1),
                          sum(p[3] for p in parts).to(torch.int32))
