"""VoxelRCNNHead — ROI refinement pooled from the multi-scale sparse voxel
levels — port of findnpropagate_tpu/models/roi_heads/voxelrcnn_head.py
(`level_voxel_centers` :37, `VoxelRCNNHead` :57, `voxelrcnn_rcnn_loss`
:163).

GRID_SIZE^3 grid points per ROI (pvrcnn_head.roi_grid_points), MSG set
abstraction (``pool_{level}``) of each over the active voxel centres of
each level of ROI_GRID_POOL.FEATURES_SOURCE ((coord + 0.5) * voxel size *
stride + range), concatenated, then the shared, cls and reg towers, each
with dropout between its layers. The levels must be sparse (gather mode)
or windowed, as in the reference: a dense level raises.
"""

from __future__ import annotations

import torch
from torch import nn

from ..pfe.voxel_set_abstraction import SALayer, voxel_centers
from .pvrcnn_head import grid_pool
from .roi_head_template import RoIHeadTemplate, two_stage_rcnn_loss

LEVEL_STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}


def level_voxel_centers(level, stride, voxel_size, pc_range):
    """A windowed or gather-mode level -> (xyz centres (B, V, 3), valid
    (B, V), feats (B, V, C))."""
    kind, a, m = level
    if kind == "win":
        _, coords, valid, feats = a
    elif kind == "sparse":
        coords, valid, feats = a.coords, a.valid, m
    else:
        raise ValueError("VoxelRCNN pooling needs a sparse/windowed level")
    return voxel_centers(coords, stride, voxel_size, pc_range), valid, feats


class VoxelRCNNHead(RoIHeadTemplate):
    def __init__(self, model_cfg, point_cloud_range, voxel_size,
                 num_class=1, level_channels=None):
        super().__init__(model_cfg, point_cloud_range, voxel_size, num_class)
        pool = model_cfg["ROI_GRID_POOL"]
        width = 0
        for src in pool["FEATURES_SOURCE"]:
            lc = pool["POOL_LAYERS"][src]
            sa = SALayer(int(level_channels[src]), lc["MLPS"],
                         lc["POOL_RADIUS"], lc["NSAMPLE"])
            self.add_module(f"pool_{src}", sa)
            width += sa.out_channels
        cin = self.add_stack("shared", int(pool["GRID_SIZE"]) ** 3 * width,
                             model_cfg["SHARED_FC"])
        self.cls_out = nn.Linear(
            self.add_stack("cls", cin, model_cfg["CLS_FC"]), 1)
        self.reg_out = nn.Linear(
            self.add_stack("reg", cin, model_cfg["REG_FC"]), 7)
        nn.init.normal_(self.cls_out.weight, std=0.01)
        nn.init.normal_(self.reg_out.weight, std=0.001)

    def _tower(self, name, x, valid, generator):
        return self.run_stack(name, x, valid,
                              range(len(self.model_cfg[f"{name.upper()}_FC"])
                                    - 1), generator)

    def forward(self, batch, generator=None):
        rois, _, roi_labels, roi_valid, targets = self.proposals(
            batch, generator)
        pool = self.model_cfg["ROI_GRID_POOL"]
        ms = batch["multi_scale_3d_features"]
        parts = []
        for src in pool["FEATURES_SOURCE"]:
            xyz, valid, feats = level_voxel_centers(
                ms[src], LEVEL_STRIDES[src], self.voxel_size,
                self.point_cloud_range)
            parts.append(grid_pool(self._modules[f"pool_{src}"], rois,
                                   roi_valid, int(pool["GRID_SIZE"]), xyz,
                                   valid, feats.float()))
        # per grid point the sources side by side, as the reference
        # concatenates before flattening the grid
        g3 = int(pool["GRID_SIZE"]) ** 3
        b, r = rois.shape[:2]
        pooled = torch.cat([p.reshape(b, r, g3, -1) for p in parts],
                           dim=-1).reshape(b, r, -1)
        shared = self._tower("shared", pooled, roi_valid, generator)
        rcnn_cls = self.cls_out(self._tower("cls", shared, roi_valid,
                                            generator))
        rcnn_reg = self.reg_out(self._tower("reg", shared, roi_valid,
                                            generator))
        return self.refined(batch, rois, roi_labels, roi_valid, rcnn_cls,
                            rcnn_reg, targets)


voxelrcnn_rcnn_loss = two_stage_rcnn_loss
