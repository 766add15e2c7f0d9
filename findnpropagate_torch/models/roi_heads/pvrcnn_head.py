"""PVRCNNHead — the keypoint-pooled refinement of PV-RCNN(++) — port of
findnpropagate_tpu/models/roi_heads/pvrcnn_head.py (`roi_grid_points`
:32, `PVRCNNHead` :44, `pvrcnn_rcnn_loss` :159).

GRID_SIZE^3 grid points per ROI, rotated and shifted to the lidar frame;
MSG set abstraction (``roi_grid_pool``) of each grid point over the
keypoints, whose features are scaled by the point head's scores; shared
FCs (dropout after the first), then the cls and reg towers. The ROIs come
from the proposal layer, or, for PV-RCNN++, from the proposal stage that
ran before the PFE.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils.geometry import rotate_points_along_z
from ..pfe.voxel_set_abstraction import SALayer
from .roi_head_template import RoIHeadTemplate, two_stage_rcnn_loss


def roi_grid_points(rois, grid_size: int):
    """rois (..., R, 7) -> (..., R, G^3, 3) grid points in the lidar
    frame, x the slowest index."""
    g = int(grid_size)
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                               indexing="ij"), -1).reshape(-1, 3)
    idx = torch.as_tensor(idx, dtype=rois.dtype, device=rois.device)
    dims = rois[..., None, 3:6]
    local = (idx + 0.5) / g * dims - dims / 2
    return rotate_points_along_z(local, rois[..., 6]) + rois[..., None, 0:3]


def grid_pool(sa, rois, roi_valid, g, src_xyz, src_valid, src_feats):
    """Set abstraction of each ROI's grid points over the sources:
    (B, R, G^3 * C)."""
    grid = roi_grid_points(rois.detach(), g)
    b, r, g3, _ = grid.shape
    gp_valid = roi_valid[..., None].expand(b, r, g3).reshape(b, r * g3)
    pooled = sa(grid.reshape(b, r * g3, 3), gp_valid, src_xyz, src_valid,
                src_feats)
    return pooled.reshape(b, r, g3 * pooled.shape[-1])


class PVRCNNHead(RoIHeadTemplate):
    def __init__(self, model_cfg, point_cloud_range, voxel_size,
                 num_class=1, input_channels=0):
        super().__init__(model_cfg, point_cloud_range, voxel_size, num_class)
        pool = model_cfg["ROI_GRID_POOL"]
        self.roi_grid_pool = SALayer(int(input_channels), pool["MLPS"],
                                     pool["POOL_RADIUS"], pool["NSAMPLE"])
        cin = int(pool["GRID_SIZE"]) ** 3 * self.roi_grid_pool.out_channels
        cin = self.add_stack("shared", cin, model_cfg["SHARED_FC"])
        self.cls_out = nn.Linear(
            self.add_stack("cls", cin, model_cfg["CLS_FC"]), 1)
        self.reg_out = nn.Linear(
            self.add_stack("reg", cin, model_cfg["REG_FC"]), 7)

    def forward(self, batch, generator=None):
        rois, _, roi_labels, roi_valid, targets = self.proposals(
            batch, generator, from_batch=True)
        kp_feats = batch["point_features"] \
            * batch["point_cls_scores"][..., None]
        pooled = grid_pool(self.roi_grid_pool, rois, roi_valid,
                           int(self.model_cfg["ROI_GRID_POOL"]["GRID_SIZE"]),
                           batch["point_coords"].detach(),
                           batch["point_valid"], kp_feats)
        x = self.run_stack("shared", pooled, roi_valid, (0,), generator)
        rcnn_cls = self.cls_out(self.run_stack("cls", x, roi_valid))
        rcnn_reg = self.reg_out(self.run_stack("reg", x, roi_valid))
        return self.refined(batch, rois, roi_labels, roi_valid, rcnn_cls,
                            rcnn_reg, targets)


pvrcnn_rcnn_loss = two_stage_rcnn_loss
