"""The plain reference detector: voxelize, sparse backbone and
HeightCompression (sparse.py), BEVFusion's camera branch and ConvFuser
where the configuration has one, the BEV backbone, the TransFusion head and
its decode; one scene at a time, float32.

Its modules carry the port's names, so one state dict loads into both.
`scene` runs one scene and returns what the benchmark compares; given
`queries` (the other side's picks) the head decodes those instead of its
own. `fmt3d` / `lower_dense_operands` make it the control (precision.py).
"""

from __future__ import annotations

import torch
from torch import nn

from .bev_backbone import BaseBEVBackbone
from .depth_lss import DepthLSSTransform
from .fpn import GeneralizedLSSFPN
from .fuser import ConvFuser
from .sparse import VoxelResBackBone8x, height_compression, voxelize_mean
from .swin import SwinTransformer
from .transfusion_head import TransFusionHead

MAX_DET = 256           # the detector's post_process slots
CAMERA_KEYS = ("camera_imgs", "lidar2image", "camera2lidar",
               "camera_intrinsics")


class ReferenceDetector(nn.Module):
    def __init__(self, model, data, class_names):
        super().__init__()
        self.pcr = [float(v) for v in data["POINT_CLOUD_RANGE"]]
        self.voxel = [float(v) for v in data["VOXEL_SIZE"]]
        self.max_voxels = int(data["MAX_VOXELS"])
        self.max_points = int(data["MAX_POINTS_PER_VOXEL"])
        self.grid = [int(round((self.pcr[i + 3] - self.pcr[i])
                               / self.voxel[i])) for i in range(3)]
        cin = len(data["POINT_FEATURES"])
        self.backbone_3d = VoxelResBackBone8x(model["BACKBONE_3D"], cin,
                                              self.grid)
        bev_channels = self.backbone_3d.out_channels \
            * self.backbone_3d.level_shapes[-1][0]
        self.image_backbone = self.neck = self.vtransform = None
        self.fuser = None
        if "IMAGE_BACKBONE" in model:
            self.image_backbone = SwinTransformer(
                model["IMAGE_BACKBONE"],
                image_size=model["VTRANSFORM"]["IMAGE_SIZE"])
            self.neck = GeneralizedLSSFPN(
                model["NECK"], in_channels=self.image_backbone.out_channels)
            self.vtransform = DepthLSSTransform(model["VTRANSFORM"])
            self.fuser = ConvFuser(model["FUSER"], in_channels=bev_channels
                                   + self.vtransform.out_channels)
            bev_channels = self.fuser.num_bev_features
        self.backbone_2d = BaseBEVBackbone(model["BACKBONE_2D"], bev_channels)
        self.dense_head = TransFusionHead(
            model["DENSE_HEAD"], self.backbone_2d.num_bev_features,
            len(class_names), class_names, self.pcr, self.voxel, self.grid)

    @property
    def has_camera(self):
        return self.image_backbone is not None

    def lidar(self, points, fmt3d=None):
        """points (P, C) of one scene -> (BEV map (1, C', ny, nx), active
        counts of levels 1-4, rulebook, whether a capacity cut cells)."""
        coords, means = voxelize_mean(points, self.pcr, self.voxel,
                                      self.max_voxels, self.max_points)
        dense, counts, rulebook, cut = self.backbone_3d(coords, means, fmt3d)
        return height_compression(dense)[None], counts, rulebook, cut

    def actives(self, points):
        """The active voxels of levels 1-4 of one scene, without the
        convolutions."""
        coords, _ = voxelize_mean(points, self.pcr, self.voxel,
                                  self.max_voxels, self.max_points)
        return self.backbone_3d.active_counts(coords)

    def camera(self, points, cams):
        """The camera branch: (1, C, ny', nx') BEV features of one scene."""
        batch = {k: cams[k][None] for k in CAMERA_KEYS}
        batch["points"] = points[None]
        batch["points_mask"] = torch.ones(points.shape[:1], dtype=torch.bool,
                                          device=points.device)[None]
        for mod in (self.image_backbone, self.neck, self.vtransform):
            batch = mod(batch)
        return batch["spatial_features_img"]

    def head(self, bev, cam=None, queries=None):
        """Fuser, BEV backbone and head over one scene's BEV map: the
        head's per-query outputs (with its heatmaps and picks)."""
        batch = {"spatial_features": bev}
        if cam is not None:
            batch["spatial_features_img"] = cam
            batch = self.fuser(batch)
        batch = self.backbone_2d(batch)
        batch = self.dense_head(batch, queries=queries)
        return batch["transfusion_preds"]

    def decode(self, res):
        return self.dense_head.get_bboxes(res, max_det=MAX_DET)

    @torch.no_grad()
    def scene(self, points, cams=None, queries=None, fmt3d=None):
        """One scene end to end: {bev, camera, res, dets, actives, rulebook,
        cut}."""
        bev, counts, rulebook, cut = self.lidar(points, fmt3d)
        cam = self.camera(points, cams) if self.has_camera else None
        res = self.head(bev, cam, queries)
        return {"bev": bev, "camera": cam, "res": res,
                "dets": self.decode(res), "actives": counts,
                "rulebook": rulebook, "cut": cut}
