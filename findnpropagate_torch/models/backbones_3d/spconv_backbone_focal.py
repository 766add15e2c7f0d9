"""VoxelBackBone8xFocal, the Focals Conv backbone — port of
findnpropagate_tpu/models/backbones_3d/spconv_backbone_focal.py
(`focal_importance_loss` :47, `VoxelBackBone8xFocal` :63).

The plain VoxelBackBone8x stack with one submanifold conv in its first
stage, and a focal conv closing stages 1-3. A focal conv predicts each
voxel's cubic importance (a 3x3x3 submanifold conv to 27 channels, no
bias, then a sigmoid: channel 26 the voxel's own, 0-25 its neighbours'),
picks the foreground (TOPK: the top THRESHOLD fraction of the valid voxels
by their own importance, ties at the cut kept; else importance >
THRESHOLD), adds a zero-feature cell at every neighbour offset of a
foreground voxel whose importance reaches THRESHOLD, and runs its own
submanifold conv + BN + ReLU over the enlarged set. MASK_MULTI scales the
features by the voxel's own importance first. In training, with
``gt_boxes`` in the batch, the centre importance is supervised against
"voxel centre inside a ground-truth box" (`focal_importance_loss`), summed
over the three focal convs as ``loss_box_of_pts``.

A windowed level dilates by `ops/sparse_ops.focal_dilate` to a capacity of
``ceil(V * FOCAL_DILATE_FACTOR / block) * block``; a dense level by 26
rolls of the selection with the wrapped slabs cleared. The importance conv
takes level 0's window and no positions cache, as in the reference, so in
the kernels' modes it and the focal submanifold conv run on K3 (at eval)
or on `windowed_conv_diff` (K3, K3 transposed and K4, in training); the
strided convs take K1 / K2 at posgather eval, as in the plain stack.

USE_IMG (windowed levels only; a dense level fails in the reference on
the widths): the importance conv also reads IMAGE_CHANNEL planes sampled
bilinearly from ``batch["images"]`` (B, H, W, C) at each voxel centre
(`_voxel_centres`: the voxel's corner scaled by the stage's stride, no
half-cell offset, as the reference) projected through
``trans_lidar_to_cam`` and ``trans_cam_to_img``; zero where the
projection leaves the image, and zero planes when the batch has no
``images``. The yaml's IMG_PRETRAIN DeepLab checkpoint is not read (the
reference samples the raw planes and loads none).

Besides the plain stack's outputs (``x_conv1`` ... ``x_conv4`` the dilated
levels), ``focal_active_counts`` (3, 2) holds each focal conv's actives
before and after its dilation over the batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...ops import sparse_ops
from ...ops.sparse_ops import (
    focal_dilate,
    kernel_offsets,
    yxz_offset_deltas,
    yxz_sentinel_start,
)
from ...ops.windowed_sparse import windowed_conv, windowed_conv_diff
from ...utils.geometry import points_in_boxes_mask
from ..blocks import MaskedBatchNorm
from .spconv_backbone import SparseConvParam, _SparseStack


def focal_importance_loss(mask_voxel, valid, targets, gamma: float = 2.0,
                          eps: float = 1e-7):
    """(B, V) centre importances, validity and in-box targets -> (B,) the
    two-class focal loss (:47): its mean over the two class slots and the
    valid voxels."""
    p_pos = torch.clamp(mask_voxel.float(), eps, 1.0 - eps)
    p_neg = 1.0 - p_pos
    t = targets.float()
    loss_pos = -t * torch.log(p_pos) * (1 - p_pos) ** gamma
    loss_neg = -(1 - t) * torch.log(p_neg) * (1 - p_neg) ** gamma
    per = torch.where(valid, (loss_pos + loss_neg) / 2.0,
                      torch.zeros_like(p_pos))
    return per.sum(1) / torch.clamp(valid.sum(1), min=1).float()


class VoxelBackBone8xFocal(_SparseStack):
    """Extra cfg keys: THRESHOLD (0.5), TOPK (True), MASK_MULTI (False),
    FOCAL_DILATE_FACTOR (1.5), USE_IMG (False), IMAGE_CHANNEL (3)."""

    residual = False
    block_counts = (1, 2, 2, 2)

    def __init__(self, model_cfg, input_channels, grid_size, voxel_size=None,
                 point_cloud_range=None):
        super().__init__(model_cfg, input_channels, grid_size, voxel_size,
                         point_cloud_range)
        cfg = model_cfg
        self.threshold = float(cfg.get("THRESHOLD", 0.5))
        self.topk = bool(cfg.get("TOPK", True))
        self.mask_multi = bool(cfg.get("MASK_MULTI", False))
        self.dilate_factor = float(cfg.get("FOCAL_DILATE_FACTOR", 1.5))
        self.use_img = bool(cfg.get("USE_IMG", False))
        self.img_ch = int(cfg.get("IMAGE_CHANNEL", 3))
        for idx in (1, 2, 3):
            c = self.level_channels[f"x_conv{idx}"]
            cin = c + (self.img_ch if self.use_img else 0)
            self.add_module(f"focal_mods_f{idx}_imp",
                            SparseConvParam(cin, 27))
            self.add_module(f"focal_mods_f{idx}_conv", SparseConvParam(c, c))
            self.add_module(f"focal_mods_f{idx}_bn", MaskedBatchNorm(c))

    def _fg_mask(self, mask_voxel, valid):
        """(B, V) foreground (:95): TOPK keeps the voxels at or above the
        k-th largest valid importance, k = max(int(n_valid * THRESHOLD),
        1); else those above THRESHOLD."""
        if not self.topk:
            return valid & (mask_voxel > self.threshold)
        mv = torch.where(valid, mask_voxel,
                         torch.full_like(mask_voxel, -float("inf")))
        n = torch.clamp(valid.sum(1), min=1).float()
        k = torch.clamp((n * self.threshold).to(torch.int64), min=1)
        k = torch.clamp(k - 1, 0, mv.shape[1] - 1)
        cut = torch.gather(torch.sort(mv, dim=1, descending=True).values, 1,
                           k[:, None])
        return valid & (mask_voxel >= cut)

    def _voxel_centres(self, coords, stage_stride):
        """(..., 3) zyx coords -> world xyz (:147): the corner of the voxel
        on the full-resolution grid, no half-cell offset."""
        vx, vy, vz = self.voxel_size
        pcr = self.point_cloud_range
        c = coords.float() * stage_stride
        return torch.stack([c[..., 2] * vx + pcr[0], c[..., 1] * vy + pcr[1],
                            c[..., 0] * vz + pcr[2]], dim=-1)

    def _img_feats_at(self, batch, coords, stage_stride):
        """(B, V, C) image planes sampled bilinearly at the projected voxel
        centres (:109), zero out of view."""
        imgs = batch["images"].float()                   # (B, H, W, C)
        l2c = batch["trans_lidar_to_cam"].float()        # (B, 4, 4)
        c2i = batch["trans_cam_to_img"].float()          # (B, 3, 4)
        b, h, w, ch = imgs.shape
        ctr = self._voxel_centres(coords, stage_stride)
        cam = (torch.cat([ctr, torch.ones_like(ctr[..., :1])], -1)
               @ l2c.transpose(1, 2))[..., :3]
        uvw = cam @ c2i[:, :, :3].transpose(1, 2) + c2i[:, None, :, 3]
        depth = torch.clamp(uvw[..., 2], min=1e-3)
        u = uvw[..., 0] / depth
        v = uvw[..., 1] / depth
        inview = ((uvw[..., 2] > 0.1) & (u >= 0) & (u < w - 1) & (v >= 0)
                  & (v < h - 1))
        u0 = torch.clamp(torch.floor(u), 0, w - 2).long()
        v0 = torch.clamp(torch.floor(v), 0, h - 2).long()
        du = torch.clamp(u - u0, 0.0, 1.0)[..., None]
        dv = torch.clamp(v - v0, 0.0, 1.0)[..., None]
        flat = imgs.reshape(b, h * w, ch)

        def at(vi, ui):
            return torch.gather(flat, 1, (vi * w + ui)[..., None].expand(
                -1, -1, ch))
        f = (at(v0, u0) * (1 - du) * (1 - dv) + at(v0, u0 + 1) * du * (1 - dv)
             + at(v0 + 1, u0) * (1 - du) * dv + at(v0 + 1, u0 + 1) * du * dv)
        return torch.where(inview[..., None], f, torch.zeros_like(f))

    def _importance_conv(self, ids, feats, wmod, shape, ovf_acc):
        """The raw importance conv of a windowed level (no bias, BN or
        epilogue), with level 0's window as the reference."""
        block, window, _ = self._win_cfg()
        deltas = yxz_offset_deltas((3, 3, 3), shape)
        sent = yxz_sentinel_start(shape)
        if self.impl == "xla":
            fn = sparse_ops.windowed_conv
        elif self.training:
            fn = windowed_conv_diff
        else:
            fn = windowed_conv
        out, ovf = fn(ids, feats, ids, wmod.kernel, deltas, block=block,
                      window=window, sentinel_start=sent)
        ovf_acc.append(ovf.sum())
        return out

    def _in_box_targets(self, batch, centres):
        """(B, P) whether each centre lies in a real ground-truth box."""
        gt = batch["gt_boxes"][..., :-1].float()
        inside = points_in_boxes_mask(centres, gt[..., :7])
        return (inside & (gt[..., 3] > 0)[..., None]).any(dim=1)

    def _focal(self, level, idx, stage_stride, batch, ovf_acc, loss_acc,
               counts):
        imp_mod = getattr(self, f"focal_mods_f{idx}_imp")
        conv_mod = getattr(self, f"focal_mods_f{idx}_conv")
        bn_mod = getattr(self, f"focal_mods_f{idx}_bn")
        supervise = self.training and "gt_boxes" in batch
        kind, a, m = level
        if kind == "win":
            ids, coords, valid, feats = a
            imp_in = feats
            if self.use_img:
                if "images" in batch:
                    img = self._img_feats_at(batch, coords, stage_stride)
                    img = torch.where(valid[..., None], img,
                                      torch.zeros_like(img))
                else:
                    img = feats.new_zeros(feats.shape[:-1] + (self.img_ch,))
                imp_in = torch.cat([feats, img.to(feats.dtype)], dim=-1)
            imp = torch.sigmoid(self._importance_conv(ids, imp_in, imp_mod,
                                                      m, ovf_acc))
            mask_voxel, mask_kernel = imp[..., -1], imp[..., :-1]
            if supervise:
                tgt = self._in_box_targets(
                    batch, self._voxel_centres(coords, stage_stride))
                loss_acc.append(focal_importance_loss(
                    mask_voxel, valid, tgt).mean())
            if self.mask_multi:
                feats = feats * mask_voxel[..., None]
            fg = self._fg_mask(mask_voxel, valid)
            cand = fg[..., None] & (mask_kernel >= self.threshold)
            block = self._win_cfg()[0]
            new_cap = -(-int(ids.shape[1] * self.dilate_factor)
                        // block) * block
            nids, ncoords, nvalid, nfeats = focal_dilate(ids, feats, cand,
                                                         m, new_cap)
            counts.append(torch.stack([valid.sum(), nvalid.sum()]))
            level = ("win", (nids, ncoords, nvalid, nfeats), m)
            return self._subm(level, conv_mod, bn_mod, ovf_acc, None)
        if kind == "dense":
            x, mask = a, m
            if self.use_img:
                raise ValueError("USE_IMG runs on windowed levels only (a "
                                 "dense level's importance conv sees no "
                                 "image planes; set DENSE_FROM_LEVEL past "
                                 "the focal stages)")
            imp = F.conv3d(x, imp_mod.dense_weight(x.dtype), None,
                           padding=1)
            imp = torch.sigmoid(torch.where(mask[:, None], imp,
                                            torch.zeros_like(imp)))
            mask_voxel, mask_kernel = imp[:, -1], imp[:, :-1]
            b = mask.shape[0]
            if supervise:
                nz, ny, nx = mask.shape[1:]
                zz, yy, xx = torch.meshgrid(
                    *(torch.arange(n, device=x.device) for n in (nz, ny, nx)),
                    indexing="ij")
                cells = torch.stack([zz, yy, xx], -1).reshape(-1, 3)
                centres = self._voxel_centres(cells, stage_stride)
                tgt = self._in_box_targets(batch, centres.expand(
                    b, -1, -1))
                loss_acc.append(focal_importance_loss(
                    mask_voxel.reshape(b, -1), mask.reshape(b, -1),
                    tgt).mean())
            if self.mask_multi:
                x = x * mask_voxel[:, None]
            fg = self._fg_mask(mask_voxel.reshape(b, -1),
                               mask.reshape(b, -1)).reshape(mask.shape)
            offs = kernel_offsets((3, 3, 3))
            offs = offs[~np.all(offs == 0, axis=1)]
            new_mask = mask
            for k, (dz, dy, dx) in enumerate(offs.tolist()):
                sel = fg & (mask_kernel[:, k] >= self.threshold)
                shifted = torch.roll(sel, (dz, dy, dx), dims=(1, 2, 3))
                # roll wraps: clear the wrapped slabs
                if dz:
                    shifted[:, 0 if dz > 0 else -1] = False
                if dy:
                    shifted[:, :, 0 if dy > 0 else -1] = False
                if dx:
                    shifted[:, :, :, 0 if dx > 0 else -1] = False
                new_mask = new_mask | shifted
            counts.append(torch.stack([mask.sum(), new_mask.sum()]))
            level = ("dense", torch.where(new_mask[:, None], x,
                                          torch.zeros_like(x)), new_mask)
            return self._subm(level, conv_mod, bn_mod, ovf_acc, None)
        raise NotImplementedError(
            "FocalSparseConv needs SUBM_MODE windowed or a dense level "
            "(set DENSE_FROM_LEVEL)")

    def forward(self, batch):
        feats = batch["voxel_features"]
        coords = batch["voxel_coords"]
        valid = batch["voxel_mask"]
        s1, s2, s3, s4, s_out = self.level_shapes
        dense_from = int(self.model_cfg.get("DENSE_FROM_LEVEL", 1))
        if not self.windowed:
            raise NotImplementedError(
                "VoxelBackBone8xFocal runs the windowed / hybrid pipeline "
                "(SUBM_MODE windowed)")
        ovf_acc, loss_acc, counts = [], [], []
        level = self._win_entry(coords, valid, feats, s1)
        if dense_from <= 0:
            level = self._to_dense(level)
        level = self._subm(level, self.w_input, self.bn_input, ovf_acc, None)
        level = self._subm(level, self.blocks1_conv0, self.blocks1_bn0,
                           ovf_acc, None)
        lvl1 = level = self._focal(level, 1, 1, batch, ovf_acc, loss_acc,
                                   counts)
        levels = [lvl1]
        for stage, (shape, stride) in enumerate(((s2, 2), (s3, 4)), start=2):
            level = self._down(level, getattr(self, f"blocks{stage}_down"),
                               getattr(self, f"blocks{stage}_down_bn"),
                               shape, self.caps[stage], ovf_acc,
                               dense_out=dense_from <= stage - 1)
            level = self._blocks(stage, level, ovf_acc, None)
            level = self._focal(level, stage, stride, batch, ovf_acc,
                                loss_acc, counts)
            levels.append(level)
        level = self._down(level, self.blocks4_down, self.blocks4_down_bn,
                           s4, self.caps[4], ovf_acc, padding=(0, 1, 1),
                           dense_out=dense_from <= 3)
        level = self._blocks(4, level, ovf_acc, None)
        levels.append(level)
        level = self._down(level, self.w_out, self.bn_out, s_out,
                           self.caps[4], ovf_acc, stride=(2, 1, 1),
                           padding=(0, 0, 0), dense_out=dense_from <= 4)
        level = self._to_dense(level)

        batch["encoded_spconv_tensor"] = level[1].float()
        batch["encoded_spconv_tensor_stride"] = 8
        batch["multi_scale_3d_features"] = {
            f"x_conv{i}": lv for i, lv in enumerate(levels, start=1)}

        def count(lv):
            kind, a, m = lv
            return (a[2] if kind == "win" else m).sum()

        batch["sparse_active_counts"] = torch.stack([count(lv)
                                                     for lv in levels])
        batch["focal_active_counts"] = torch.stack(counts)
        batch["sparse_window_overflow"] = torch.stack(ovf_acc).sum() \
            if ovf_acc else torch.zeros((), dtype=torch.int64,
                                        device=feats.device)
        if loss_acc:
            # summed over the focal convs, added by the detector's loss
            batch["loss_box_of_pts"] = torch.stack(loss_acc).sum()
        return batch
