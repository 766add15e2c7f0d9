"""Detector assembly, inference and training loss — port of
findnpropagate_tpu/models/detectors/detector3d.py (`DetectorModule`
:79-280 with `_voxelize` :245-262, `loss` :305-319, `post_process`
:321-374, the head branches of `build_detector` :400-460).

The topology voxelize -> VFE -> (sparse 3D backbone) -> (map to BEV) ->
(2D backbone) -> dense head runs over a dict batch, each module taken
from its registry by the yaml's NAME:
  * VFE: MeanVFE folds into `voxelize_mean`; the pillar and dynamic VFEs
    read the (V, T, C) bucket of `voxelize` (the dynamic ones its coords
    and the raw points);
  * BACKBONE_3D (optional): VoxelResBackBone8x, VoxelBackBone8x,
    VoxelResBackBone8xVoxelNeXt, VoxelResBackBone8xVoxelNeXt2D,
    PillarRes18BackBone8x, PillarBackBone8x;
  * MAP_TO_BEV (optional): HeightCompression, PointPillarScatter;
  * BACKBONE_2D (optional): BaseBEVBackbone, BaseBEVBackboneV1 (whose
    inputs are the sparse backbone's two dense maps);
  * DENSE_HEAD: TransFusionHead, TransFusionHeadAM, CenterHead,
    CenterHeadCLIP, AnchorHeadSingle, AnchorHeadMulti, VoxelNeXtHead
    (which reads the backbone's sparse BEV list: no map to BEV and no 2D
    backbone).
That is TransFusion-LiDAR (and its anchor-matching head), CenterPoint
(voxel and pillar), PointPillar, SECOND / SECONDNet, VoxelNeXt (3D and
2D) and PillarNet. `post_process` decodes the head's outputs into
fixed-size Detections: TransFusion its queries, the CenterPoint and
VoxelNeXt heads their heatmaps, the anchor heads through the generic
class-agnostic
`post_processing.post_process` (POST_PROCESSING.NMS_CONFIG; its
MULTI_CLASSES_NMS and OUTPUT_RAW_SCORE are not read, as in the
reference). The forward keeps gradients when the module is in training
mode (`.train()`), where every BN uses and records batch statistics;
`loss(batch, generator)` runs it so and returns the head's loss and its
`tb` dictionary, with the sparse backbone's ``sparse_window_overflow``
where there is one. Other detectors and modules raise NotImplementedError
(ROADMAP.md, queue 1 item 15).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.voxelize import voxelize, voxelize_mean
from ..backbones_2d import BACKBONE_2D_REGISTRY, MAP_TO_BEV_REGISTRY
from ..backbones_3d import BACKBONE_3D_REGISTRY
from ..dense_heads import DENSE_HEAD_REGISTRY
from ..post_processing import post_process
from ..vfe import VFE_REGISTRY

DETECTORS = ("TransFusion", "CenterPoint", "PointPillar", "SECOND",
             "SECONDNet", "VoxelNeXt", "PillarNet")
_PORTED = {"VFE": ("MeanVFE", *VFE_REGISTRY),
           "BACKBONE_3D": tuple(BACKBONE_3D_REGISTRY),
           "MAP_TO_BEV": tuple(MAP_TO_BEV_REGISTRY),
           "BACKBONE_2D": tuple(BACKBONE_2D_REGISTRY),
           "DENSE_HEAD": tuple(DENSE_HEAD_REGISTRY)}
_OPTIONAL = ("BACKBONE_3D", "MAP_TO_BEV", "BACKBONE_2D")
_NOT_PORTED = ("PFE", "POINT_HEAD", "ROI_HEAD", "IMAGE_BACKBONE", "NECK",
               "VTRANSFORM", "FUSER")


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue "
                               "1 item 15)")


class DetectorModule(nn.Module):
    """batch dict {points (B, P, F), points_mask (B, P)} in, batch dict
    with the head's outputs (``transfusion_preds``, ``center_preds``,
    ``center_clip_preds``, ``voxelnext_preds`` or the anchor heads'
    ``batch_cls_preds`` / ``batch_box_preds``) and the backbone telemetry
    out."""

    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 voxel_size, point_cloud_range, num_point_features,
                 max_voxels, max_points_per_voxel):
        super().__init__()
        cfg = model_cfg
        if cfg.get("NAME") not in (*DETECTORS, None):
            raise _not_ported(f"detector {cfg.get('NAME')!r}")
        for key, names in _PORTED.items():
            if key in _OPTIONAL and key not in cfg:
                continue
            if cfg.get(key, {}).get("NAME") not in names:
                raise _not_ported(f"{key} {cfg.get(key, {}).get('NAME')!r}")
        for key in _NOT_PORTED:
            if key in cfg:
                raise _not_ported(key)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.max_voxels = int(max_voxels)
        self.max_points_per_voxel = int(max_points_per_voxel)
        self.post_cfg = cfg.get("POST_PROCESSING", {})
        self.mean_vfe = cfg["VFE"]["NAME"] == "MeanVFE"
        in_ch = int(num_point_features)
        self.vfe = None
        if not self.mean_vfe:
            self.vfe = VFE_REGISTRY[cfg["VFE"]["NAME"]](
                cfg["VFE"], num_point_features, self.voxel_size,
                self.point_cloud_range, self.grid_size)
            in_ch = self.vfe.output_dim
        self.backbone_3d = None
        if "BACKBONE_3D" in cfg:
            self.backbone_3d = BACKBONE_3D_REGISTRY[
                cfg["BACKBONE_3D"]["NAME"]](cfg["BACKBONE_3D"], in_ch,
                                            self.grid_size)
        self.map_to_bev = self.backbone_2d = None
        if "MAP_TO_BEV" in cfg:
            self.map_to_bev = MAP_TO_BEV_REGISTRY[cfg["MAP_TO_BEV"]["NAME"]](
                cfg["MAP_TO_BEV"], self.grid_size)
        if "BACKBONE_2D" in cfg:
            bb2 = cfg["BACKBONE_2D"]
            if self.map_to_bev is not None:
                bb2_in = self.map_to_bev.num_bev_features
            elif bb2["NAME"] == "BaseBEVBackboneV1":
                bb2_in = self.backbone_3d.multi_scale_channels
            else:
                bb2_in = int(bb2.get("INPUT_CHANNELS", 64))
            self.backbone_2d = BACKBONE_2D_REGISTRY[bb2["NAME"]](bb2, bb2_in)
        # fully sparse heads (VoxelNeXt) read the 3D backbone's output
        head_in = (self.backbone_2d if self.backbone_2d is not None
                   else self.backbone_3d).num_bev_features
        head = cfg["DENSE_HEAD"]
        kw = {}
        if head["NAME"] == "CenterHead" and head.get(
                "PREDICT_BOXES_WHEN_TRAINING"):
            kw["predict_boxes_when_training"] = True
        self.dense_head = DENSE_HEAD_REGISTRY[head["NAME"]](
            head, head_in, num_class, class_names, self.point_cloud_range,
            self.voxel_size, self.grid_size, **kw)

    def _voxelize(self, batch):
        args = (batch["points"], batch["points_mask"], self.point_cloud_range,
                self.voxel_size, self.grid_size, self.max_voxels,
                self.max_points_per_voxel)
        if self.mean_vfe:
            out = voxelize_mean(*args)
            batch["voxel_features"] = out.means
        else:
            out = voxelize(*args)
            batch["voxels"] = out.voxels
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
            for mod in (self.vfe, self.backbone_3d, self.map_to_bev,
                        self.backbone_2d):
                if mod is not None:
                    batch = mod(batch)
            return self.dense_head(batch, generator)

    def loss(self, batch, generator=None):
        """Training forward + head loss: (loss, tb). The module must be in
        training mode. With a sparse backbone tb carries
        ``sparse_window_overflow``: nonzero means a window truncated a
        neighbour span and the activations are wrong."""
        if not self.training:
            raise RuntimeError("loss() needs the module in training mode")
        out = self(batch, generator)
        loss, tb = self.dense_head.compute_loss(out)
        if "sparse_window_overflow" in out:
            tb["sparse_window_overflow"] = out["sparse_window_overflow"]
        return loss, tb

    @torch.no_grad()
    def post_process(self, out_batch, max_det: int = 256):
        """Detections of the head's outputs: TransFusion decodes its
        queries (max_det slots), the CenterPoint and VoxelNeXt heads their
        heatmaps, the
        anchor heads' boxes go through rotated NMS (NMS_POST_MAXSIZE
        slots)."""
        if "transfusion_preds" in out_batch:
            return self.dense_head.get_bboxes(out_batch["transfusion_preds"],
                                              max_det=max_det)
        if "center_preds" in out_batch or "center_clip_preds" in out_batch \
                or "voxelnext_preds" in out_batch:
            return self.dense_head.get_bboxes(out_batch)
        pc = self.post_cfg
        nms_cfg = pc["NMS_CONFIG"]
        return post_process(
            out_batch["batch_cls_preds"], out_batch["batch_box_preds"],
            float(nms_cfg["NMS_THRESH"]),
            score_thresh=float(pc.get("SCORE_THRESH", 0.1)),
            nms_pre=int(nms_cfg.get("NMS_PRE_MAXSIZE", 1024)),
            nms_post=int(nms_cfg.get("NMS_POST_MAXSIZE", 256)),
            normalized=bool(out_batch.get("cls_preds_normalized", False)))


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
