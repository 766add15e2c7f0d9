"""Detector assembly, TransFusion-LiDAR inference and training loss — port
of findnpropagate_tpu/models/detectors/detector3d.py (`DetectorModule`
:79-280 with `_voxelize`, `loss` :305-319, `post_process` :321-360, the
TransFusion branch :434-460).

The fixed topology voxelize (MeanVFE folded into `voxelize_mean`) ->
VoxelResBackBone8x -> HeightCompression -> BaseBEVBackbone ->
TransFusionHead runs over a dict batch; `post_process` decodes the head's
queries into fixed-size Detections. The forward keeps gradients when the
module is in training mode (`.train()`), where every BN uses and records
batch statistics; `loss(batch, generator)` runs it so and returns the
head's loss and its `tb` dictionary with the backbone's
``sparse_window_overflow`` added. Other topologies raise
NotImplementedError (ROADMAP.md, queue 1 item 13).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.voxelize import voxelize_mean
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import HeightCompression
from ..backbones_3d.spconv_backbone import VoxelResBackBone8x
from ..dense_heads.transfusion_head import TransFusionHead

_PORTED = {"VFE": "MeanVFE", "BACKBONE_3D": "VoxelResBackBone8x",
           "MAP_TO_BEV": "HeightCompression",
           "BACKBONE_2D": "BaseBEVBackbone",
           "DENSE_HEAD": "TransFusionHead"}


class DetectorModule(nn.Module):
    """batch dict {points (B, P, F), points_mask (B, P)} in, batch dict with
    ``transfusion_preds`` (and the backbone telemetry) out."""

    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 voxel_size, point_cloud_range, num_point_features,
                 max_voxels, max_points_per_voxel):
        super().__init__()
        cfg = model_cfg
        if cfg.get("NAME") not in ("TransFusion", None):
            raise NotImplementedError(
                f"detector {cfg.get('NAME')!r} is not ported yet (ROADMAP.md "
                "queue 1 item 13)")
        for key, name in _PORTED.items():
            if cfg.get(key, {}).get("NAME") != name:
                raise NotImplementedError(
                    f"{key} {cfg.get(key, {}).get('NAME')!r} is not ported "
                    "yet (ROADMAP.md queue 1 item 13)")
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.max_voxels = int(max_voxels)
        self.max_points_per_voxel = int(max_points_per_voxel)
        self.backbone_3d = VoxelResBackBone8x(
            cfg["BACKBONE_3D"], num_point_features, self.grid_size)
        self.map_to_bev = HeightCompression(cfg["MAP_TO_BEV"])
        self.backbone_2d = BaseBEVBackbone(
            cfg["BACKBONE_2D"], self.map_to_bev.num_bev_features)
        self.dense_head = TransFusionHead(
            cfg["DENSE_HEAD"], self.backbone_2d.num_bev_features, num_class,
            class_names, self.point_cloud_range, self.voxel_size,
            self.grid_size)

    def _voxelize(self, batch):
        out = voxelize_mean(batch["points"], batch["points_mask"],
                            self.point_cloud_range, self.voxel_size,
                            self.grid_size, self.max_voxels,
                            self.max_points_per_voxel)
        batch["voxel_features"] = out.means
        batch["voxel_coords"] = out.coords
        batch["voxel_num_points"] = out.num_points
        batch["voxel_mask"] = out.voxel_mask
        return batch

    def forward(self, batch, generator=None):
        """Gradients are kept in training mode only. generator: the
        torch.Generator of the head's dropout masks (training)."""
        with torch.set_grad_enabled(self.training):
            with torch.no_grad():
                batch = self._voxelize(dict(batch))
            for mod in (self.backbone_3d, self.map_to_bev, self.backbone_2d):
                batch = mod(batch)
            return self.dense_head(batch, generator)

    def loss(self, batch, generator=None):
        """Training forward + head loss: (loss, tb). The module must be in
        training mode. tb carries ``sparse_window_overflow``: nonzero means
        a window truncated a neighbour span and the activations are wrong."""
        if not self.training:
            raise RuntimeError("loss() needs the module in training mode")
        out = self(batch, generator)
        loss, tb = self.dense_head.compute_loss(out)
        tb["sparse_window_overflow"] = out["sparse_window_overflow"]
        return loss, tb

    @torch.no_grad()
    def post_process(self, out_batch, max_det: int = 256):
        return self.dense_head.get_bboxes(out_batch["transfusion_preds"],
                                          max_det=max_det)


def build_detector(model_cfg, num_class, dataset, device=None):
    """dataset provides class_names, grid_size, voxel_size,
    point_cloud_range, num_point_features, max_voxels and
    max_points_per_voxel. Returns the module in eval mode on `device`
    (CUDA unless named; raises when CUDA is missing and none is named)."""
    from ... import resolve_device

    det = DetectorModule(
        model_cfg, num_class, tuple(dataset.class_names),
        dataset.grid_size, dataset.voxel_size, dataset.point_cloud_range,
        dataset.num_point_features, dataset.max_voxels,
        dataset.max_points_per_voxel)
    return det.to(resolve_device(device)).eval()
