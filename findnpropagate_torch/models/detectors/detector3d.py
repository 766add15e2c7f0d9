"""Detector assembly, inference and training loss — port of
findnpropagate_tpu/models/detectors/detector3d.py (`DetectorModule`
:79-280 with `_voxelize` :245-262, `loss` :305-319, `post_process`
:321-374, the head branches of `build_detector` :400-460).

The topology voxelize -> VFE -> (3D backbone) -> (map to BEV) ->
(2D backbone) -> (dense head) runs over a dict batch, each module taken
from its registry by the yaml's NAME:
  * VFE: MeanVFE folds into `voxelize_mean`; the pillar and dynamic VFEs
    read the (V, T, C) bucket of `voxelize` (the dynamic ones its coords
    and the raw points); without a VFE (PointRCNN, whose dataset has no
    grid) nothing is voxelized, nor for CaDDN's ImageVFE, which lifts the
    camera image into the grid's dense volume (:272-275);
  * BACKBONE_3D (optional): VoxelResBackBone8x, VoxelBackBone8x,
    VoxelBackBone8xFocal (its ``loss_box_of_pts`` added to the loss),
    VoxelResBackBone8xVoxelNeXt, VoxelResBackBone8xVoxelNeXt2D,
    PillarRes18BackBone8x, PillarBackBone8x, UNetV2 (point features at
    the voxel centres too), PointNet2MSG (over the raw points);
  * MAP_TO_BEV (optional): HeightCompression, PointPillarScatter,
    Conv2DCollapse (CaDDN's);
  * the camera branch of BEVFusion (optional, :138-162): IMAGE_BACKBONE
    (SwinTransformer, ResNet18, CLIPResNet), NECK (GeneralizedLSSFPN),
    VTRANSFORM (DepthLSSTransform) and FUSER (ConvFuser, whose output
    the 2D backbone reads);
  * BACKBONE_2D (optional): BaseBEVBackbone, BaseBEVBackboneV1 (whose
    inputs are the sparse backbone's two dense maps);
  * DENSE_HEAD (none in PointRCNN): TransFusionHead, TransFusionHeadAM,
    CenterHead, CenterHeadCLIP, AnchorHeadSingle, AnchorHeadMulti,
    VoxelNeXtHead (which reads the backbone's sparse BEV list: no map to
    BEV and no 2D backbone).
  * PFE (optional): VoxelSetAbstraction, keypoint features from the raw
    points, the BEV map and the backbone's levels;
  * POINT_HEAD (optional): PointHeadSimple over the keypoints,
    PointHeadBox and PointIntraPartOffsetHead over the backbone's points
    (the first stage of PointRCNN and PartA2_free: their decoded point
    boxes are the proposals);
  * ROI_HEAD (optional): SECONDHead, PVRCNNHead, VoxelRCNNHead,
    PartA2FCHead, PointRCNNHead, MPPNetHead, MPPNetHeadE2E, which
    refine the first stage's boxes (its head then decodes boxes in
    training too, and with an ROI head those boxes keep their gradient:
    the JAX package differentiates the ROI losses through the ROIs into
    the first stage). With ``PROPOSAL_BEFORE_PFE`` (PV-RCNN++,
    `RoIProposalStage`) the proposals and the ROI sampling run right
    after the dense head, before the PFE, which samples its keypoints
    near them.
That is TransFusion-LiDAR (and its anchor-matching head), CenterPoint
(voxel and pillar), PointPillar, SECOND / SECONDNet, VoxelNeXt (3D and
2D), PillarNet, CaDDN, BEVFusion, and the two-stage SECONDNetIoU,
VoxelRCNN (also over the focal backbone), PVRCNN, PVRCNNPlusPlus,
PartA2Net and PointRCNN, and MPPNet, whose ROI head is the whole model
(its proposals and multi-frame points come from the loader; its loss is
the head's alone, :506-518), and MPPNetE2E, a CenterPoint first stage
before the streaming MPPNetHeadE2E, which reads its memory bank from the
batch (``memory_rois``, ``poses``, ``memory_feature``, ``sample_idx``)
and raises a KeyError without it, as the reference's does
(`RoIProposalStage` :38-76, the
assembly and module order :129-136, :200-243, the two-stage decode
:339-355, the point-based dataset :383-386 and the TwoStageTools loss
:519-575, the point head's loss chosen by its NAME; CaddnTools
:461-482 and FocalTools :484-504). `post_process`
decodes the head's outputs into fixed-size Detections: MPPNet's through
`post_processing.post_process_mppnet` (:322-339), a two-stage
detector through `post_processing.post_process_two_stage` (the ROI
head's scores, the ROIs' labels), TransFusion its queries, the
CenterPoint and VoxelNeXt heads their heatmaps, the anchor heads through
the generic class-agnostic
`post_processing.post_process` (POST_PROCESSING.NMS_CONFIG; its
MULTI_CLASSES_NMS and OUTPUT_RAW_SCORE are not read, as in the
reference). The forward keeps gradients when the module is in training
mode (`.train()`), where every BN uses and records batch statistics;
`loss(batch, generator)` runs it so and returns the head's loss (a
two-stage detector adds the ROI head's and the point head's) and its
`tb` dictionary, with the sparse backbone's ``sparse_window_overflow``
where there is one. Under a profiler the forward records the spans of
utils/trace.py: the root `forward` with the batch's scans, `voxelize` and
each module by its attribute (STAGES, then the heads); `post_process`
records `decode` and `loss` the loss's own part. The ROI sampling's
uniform draws come from the generator, or from ``batch["roi_draws"]``
(B, NMS_POST_MAXSIZE) where the caller gives them (MPPNet's from
``batch["mppnet_draws"]``).

As in the reference (`DetectorModule.setup` :92-243), the chain is built
from the keys present in MODEL and MODEL.NAME is never read: every key is
optional, a yaml's modules build under any detector name, and a module
NAME outside its registry raises that registry's KeyError (a POINT_HEAD of
another NAME is the simple head, :200-221). What the reference's forward
lacks, the port's lacks too: a voxel backbone without a VFE, or an ROI
head without the first stage's boxes, raises a KeyError naming the
missing batch key.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.voxelize import voxelize, voxelize_mean
from ...utils import trace
from ..backbones_2d import BACKBONE_2D_REGISTRY, MAP_TO_BEV_REGISTRY
from ..backbones_2d.fuser import FUSER_REGISTRY
from ..backbones_3d import BACKBONE_3D_REGISTRY
from ..backbones_image import IMAGE_BACKBONE_REGISTRY, NECK_REGISTRY
from ..backbones_3d.spconv_backbone import _SparseStack
from ..dense_heads import DENSE_HEAD_REGISTRY
from ..dense_heads.point_head_box import PointHeadBox, point_head_box_loss
from ..dense_heads.point_head_simple import PointHeadSimple, point_head_loss
from ..dense_heads.point_intra_part_head import (
    PointIntraPartOffsetHead,
    point_part_head_loss,
)
from ..pfe import PFE_REGISTRY
from ..post_processing import post_process, post_process_two_stage
from ..post_processing import post_process_mppnet
from ..roi_heads import ROI_HEAD_REGISTRY
from ..roi_heads.mppnet_head import mppnet_loss
from ..roi_heads.pvrcnn_head import pvrcnn_rcnn_loss
from ..roi_heads.roi_head_template import RoIHeadTemplate
from ..roi_heads.second_head import rcnn_iou_loss
from ..vfe import VFE_REGISTRY
from ..vfe.image_vfe import ImageVFE, ddn_loss
from ..view_transforms import VTRANSFORM_REGISTRY

POINT_HEADS = {"PointHeadSimple": PointHeadSimple,
               "PointHeadBox": PointHeadBox,
               "PointIntraPartOffsetHead": PointIntraPartOffsetHead}
# the ROI heads of MPPNet (the offline head, whose loss is the model's) and
# of MPPNetE2E
MPPNET_HEADS = ("MPPNetHead", "MPPNetHeadE2E")
# the modules of the forward before the dense head, in order, each run in a
# span of its attribute's name (utils/trace.py)
STAGES = ("vfe", "backbone_3d", "map_to_bev", "image_backbone", "neck",
          "vtransform", "fuser", "backbone_2d")


class RoIProposalStage(RoIHeadTemplate):
    """PV-RCNN++'s proposal layer and ROI sampling before the PFE: writes
    rois / roi_labels / roi_valid (roi_scores at eval, the sampling's
    targets as roi_targets in training) into the batch, for the PFE's
    proposal-centric keypoints and the ROI head, which takes them as they
    are. No parameters."""

    def forward(self, batch, generator=None):
        rois, scores, labels, valid, targets = self.proposals(batch,
                                                              generator)
        batch.update(rois=rois, roi_labels=labels, roi_valid=valid)
        if self.training:
            batch["roi_targets"] = targets
        else:
            batch["roi_scores"] = scores
        return batch


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
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.max_voxels = int(max_voxels)
        self.max_points_per_voxel = int(max_points_per_voxel)
        self.post_cfg = cfg.get("POST_PROCESSING", {})
        # without a VFE (point-based) nothing is voxelized and the 3D
        # backbone reads the raw points; CaDDN's ImageVFE reads the camera
        vfe_name = cfg.get("VFE", {}).get("NAME")
        self.voxelized = "VFE" in cfg and vfe_name != "ImageVFE"
        self.mean_vfe = vfe_name == "MeanVFE"
        in_ch = int(num_point_features)
        self.vfe = None
        if "VFE" in cfg and not self.mean_vfe:
            self.vfe = VFE_REGISTRY[vfe_name](
                cfg["VFE"], num_point_features, self.voxel_size,
                self.point_cloud_range, self.grid_size)
            in_ch = self.vfe.output_dim
        self.backbone_3d = None
        if "BACKBONE_3D" in cfg:
            self.backbone_3d = BACKBONE_3D_REGISTRY[
                cfg["BACKBONE_3D"]["NAME"]](
                cfg["BACKBONE_3D"], in_ch, self.grid_size, self.voxel_size,
                self.point_cloud_range)
        self.map_to_bev = self.backbone_2d = None
        if "MAP_TO_BEV" in cfg:
            kw = {"in_channels": in_ch} \
                if cfg["MAP_TO_BEV"]["NAME"] == "Conv2DCollapse" else {}
            self.map_to_bev = MAP_TO_BEV_REGISTRY[cfg["MAP_TO_BEV"]["NAME"]](
                cfg["MAP_TO_BEV"], self.grid_size, **kw)
            if isinstance(self.backbone_3d, _SparseStack) \
                    and cfg["MAP_TO_BEV"]["NAME"] == "HeightCompression":
                # the width the backbone gives (C x nz): the reference's
                # flax layers infer it and read no NUM_BEV_FEATURES
                bb = self.backbone_3d
                self.map_to_bev.num_bev_features = \
                    bb.out_channels * bb.level_shapes[-1][0]
        self._camera_branch(cfg)
        if "BACKBONE_2D" in cfg:
            bb2 = cfg["BACKBONE_2D"]
            if self.fuser is not None:
                bb2_in = self.fuser.num_bev_features
            elif self.map_to_bev is not None:
                bb2_in = self.map_to_bev.num_bev_features
            elif bb2["NAME"] == "BaseBEVBackboneV1":
                bb2_in = self.backbone_3d.multi_scale_channels
            else:
                bb2_in = int(bb2.get("INPUT_CHANNELS", 64))
            self.backbone_2d = BACKBONE_2D_REGISTRY[bb2["NAME"]](bb2, bb2_in)
        self.dense_head = None
        if "DENSE_HEAD" in cfg:
            # fully sparse heads (VoxelNeXt) read the 3D backbone's output
            head_in = (self.backbone_2d if self.backbone_2d is not None
                       else self.backbone_3d).num_bev_features
            head = cfg["DENSE_HEAD"]
            kw = {}
            if head["NAME"] == "CenterHead" and (head.get(
                    "PREDICT_BOXES_WHEN_TRAINING") or "ROI_HEAD" in cfg):
                kw["predict_boxes_when_training"] = True
            self.dense_head = DENSE_HEAD_REGISTRY[head["NAME"]](
                head, head_in, num_class, class_names,
                self.point_cloud_range, self.voxel_size, self.grid_size,
                **kw)
        self._two_stage(cfg, num_class, num_point_features)

    def _camera_branch(self, cfg):
        """BEVFusion's camera branch (:138-162): the image backbone, its
        neck, the view transform and the fuser, each sized from the
        modules before it (the reference's flax layers infer the widths
        the yaml's IN_CHANNELS / IN_CHANNEL state)."""
        self.image_backbone = self.neck = self.vtransform = None
        self.fuser = None
        if "IMAGE_BACKBONE" in cfg:
            name = cfg["IMAGE_BACKBONE"]["NAME"]
            # Swin's windows follow its maps: the view transform's images
            kw = {"image_size": cfg["VTRANSFORM"]["IMAGE_SIZE"]} \
                if name == "SwinTransformer" and "VTRANSFORM" in cfg else {}
            self.image_backbone = IMAGE_BACKBONE_REGISTRY[name](
                cfg["IMAGE_BACKBONE"], **kw)
        if "NECK" in cfg:
            self.neck = NECK_REGISTRY[cfg["NECK"]["NAME"]](
                cfg["NECK"], in_channels=getattr(self.image_backbone,
                                                 "out_channels", None))
        if "VTRANSFORM" in cfg:
            self.vtransform = VTRANSFORM_REGISTRY[
                cfg["VTRANSFORM"]["NAME"]](cfg["VTRANSFORM"])
        if "FUSER" in cfg:
            cin = None
            if self.map_to_bev is not None and self.vtransform is not None:
                cin = self.map_to_bev.num_bev_features \
                    + self.vtransform.out_channels
            self.fuser = FUSER_REGISTRY[cfg["FUSER"]["NAME"]](
                cfg["FUSER"], in_channels=cin)

    def _two_stage(self, cfg, num_class, num_point_features):
        """The PFE, point head and ROI head of a two-stage yaml (and
        PV-RCNN++'s proposal stage), sized from the modules before them."""
        self.pfe = self.point_head = self.roi_head = None
        self.roi_proposal = None
        levels = getattr(self.backbone_3d, "level_channels", {})
        if "PFE" in cfg:
            self.pfe = PFE_REGISTRY[cfg["PFE"]["NAME"]](
                cfg["PFE"], self.voxel_size, self.point_cloud_range,
                num_rawpoint_features=min(int(num_point_features), 4),
                num_bev_features=self.map_to_bev.num_bev_features
                if self.map_to_bev is not None else 0,
                level_channels=levels)
        if "POINT_HEAD" in cfg:
            ph = cfg["POINT_HEAD"]
            # any other NAME is the simple head, as in the reference
            cls = POINT_HEADS.get(ph.get("NAME"), PointHeadSimple)
            if cls is PointHeadSimple:
                self.point_head = cls(
                    ph, self.pfe.num_point_features_before_fusion if bool(
                        ph.get("USE_POINT_FEATURES_BEFORE_FUSION", True))
                    else self.pfe.num_point_features)
            else:
                # the point-wise heads read the 3D backbone's point
                # features; Part-A2's scores num_class classes, PointRCNN's
                # one (the fork's binary head)
                kw = {"num_class": int(num_class)} \
                    if cls is PointIntraPartOffsetHead else {}
                self.point_head = cls(
                    ph, self.backbone_3d.num_point_features, **kw)
        if "ROI_HEAD" not in cfg:
            return
        roi = cfg["ROI_HEAD"]
        if self.dense_head is not None:
            # the first stage's boxes feed the proposal layer in training
            # too, with their gradient (the ROI losses reach the first
            # stage through the ROIs, as in the JAX package)
            self.dense_head.predict_boxes_when_training = True
            self.dense_head.boxes_need_grad = True
        n_cls = 1 if roi.get("CLASS_AGNOSTIC", True) else int(num_class)
        kw = {}
        if roi["NAME"] == "VoxelRCNNHead":
            kw["level_channels"] = levels
        elif roi["NAME"] == "PVRCNNHead":
            kw["input_channels"] = self.pfe.num_point_features
        elif roi["NAME"] in ("PartA2FCHead", "PointRCNNHead"):
            kw["input_channels"] = self.backbone_3d.num_point_features
        elif roi["NAME"] in MPPNET_HEADS:
            kw["num_point_features"] = int(num_point_features)
        else:
            kw["input_channels"] = self.backbone_2d.num_bev_features
        self.roi_head = ROI_HEAD_REGISTRY[roi["NAME"]](
            roi, self.point_cloud_range, self.voxel_size, n_cls, **kw)
        if roi.get("PROPOSAL_BEFORE_PFE"):
            self.roi_proposal = RoIProposalStage(
                roi, self.point_cloud_range, self.voxel_size, n_cls)
        self.roi_loss = rcnn_iou_loss if roi["NAME"] == "SECONDHead" \
            else pvrcnn_rcnn_loss
        self.roi_loss_cfg = roi["LOSS_CONFIG"]
        if roi["NAME"] == "MPPNetHead":
            # the ROI head's whole config: its aux-loss switch too
            self.roi_loss, self.roi_loss_cfg = mppnet_loss, roi

    @trace.spanned("voxelize")
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
        with torch.set_grad_enabled(self.training), \
                trace.span("forward", scans=batch.get("points")):
            batch = dict(batch)
            if self.voxelized:
                with torch.no_grad():
                    batch = self._voxelize(batch)
            for name in STAGES:
                batch = self._stage(name, batch)
            batch = self._stage("dense_head", batch, generator)
            batch = self._stage("roi_proposal", batch, generator)
            batch = self._stage("pfe", batch)
            batch = self._stage("point_head", batch)
            return self._stage("roi_head", batch, generator)

    def _stage(self, name, batch, *args):
        """The module at attribute `name` on the batch, in a span of that
        name; the batch as it is without one."""
        mod = getattr(self, name)
        if mod is None:
            return batch
        with trace.span(name):
            return mod(batch, *args)

    def compute_loss(self, out):
        """The dense head's loss (none without one: PointRCNN), CaDDN's
        depth loss and the focal backbone's ``loss_box_of_pts`` where there
        are, plus the ROI head's and the point head's, chosen by its NAME,
        for a two-stage detector (TwoStageTools): (loss, tb). With
        MPPNetHead the loss is the ROI head's alone (MPPNetTools)."""
        if self.roi_head is not None and self.roi_loss is mppnet_loss:
            return self.roi_loss(out, self.roi_loss_cfg)
        loss, tb = self.dense_head.compute_loss(out) \
            if self.dense_head is not None else (0.0, {})
        if isinstance(self.vfe, ImageVFE):
            # CaDDN (CaddnTools): the depth-distribution loss
            loss_d, tb_d = ddn_loss(out, self.vfe.model_cfg)
            tb = {**tb, **tb_d}
            loss = loss + loss_d
        if "loss_box_of_pts" in out and self.dense_head is not None:
            # Focals Conv (FocalTools): the importance supervision
            tb = {**tb, "loss_box_of_pts": out["loss_box_of_pts"]}
            loss = loss + out["loss_box_of_pts"]
        if self.roi_head is None:
            return loss, tb
        loss2, tb2 = self.roi_loss(out, self.roi_loss_cfg)
        tb = dict(tb)
        tb.update(tb2)
        loss = loss + loss2
        if self.point_head is not None:
            pc = self.point_head.model_cfg
            if isinstance(self.point_head, PointHeadBox):
                lp, tbp = point_head_box_loss(out, pc)
            elif isinstance(self.point_head, PointIntraPartOffsetHead):
                lp, tbp = point_part_head_loss(out, pc,
                                               self.point_head.num_class)
            else:
                lp, tbp = point_head_loss(
                    out, pc["LOSS_CONFIG"], extra_width=tuple(pc.get(
                        "TARGET_CONFIG", {}).get("GT_EXTRA_WIDTH",
                                                 (0.2, 0.2, 0.2))))
            loss = loss + lp
            tb.update(tbp)
        return loss, tb

    def loss(self, batch, generator=None):
        """Training forward + head loss: (loss, tb). The module must be in
        training mode. With a sparse backbone tb carries
        ``sparse_window_overflow``: nonzero means a window truncated a
        neighbour span and the activations are wrong."""
        if not self.training:
            raise RuntimeError("loss() needs the module in training mode")
        out = self(batch, generator)
        with trace.span("loss"):
            loss, tb = self.compute_loss(out)
        if "sparse_window_overflow" in out:
            tb["sparse_window_overflow"] = out["sparse_window_overflow"]
        return loss, tb

    @trace.spanned("decode")
    @torch.no_grad()
    def post_process(self, out_batch, max_det: int = 256):
        """Detections of the head's outputs: a two-stage detector's
        second-stage scores on its boxes and the ROIs' labels, TransFusion
        its queries (max_det slots), the CenterPoint and VoxelNeXt heads
        their heatmaps; the two-stage and the anchor heads' boxes go
        through rotated NMS (NMS_POST_MAXSIZE slots)."""
        if "mppnet_preds" in out_batch:     # before the RPN's outputs
            pc = self.post_cfg
            return post_process_mppnet(
                out_batch["batch_cls_preds"][..., 0],
                out_batch["batch_box_preds"], out_batch["batch_roi_labels"],
                out_batch.get("roi_valid"), *self._nms_args(),
                not_apply_nms_for_vel=bool(pc.get("NOT_APPLY_NMS_FOR_VEL",
                                                  False)))
        if "rcnn_iou" in out_batch:    # before the RPN's own outputs
            return post_process_two_stage(
                out_batch["batch_cls_preds"], out_batch["batch_box_preds"],
                out_batch["batch_roi_labels"], out_batch.get("roi_valid"),
                *self._nms_args())
        if "transfusion_preds" in out_batch:
            return self.dense_head.get_bboxes(out_batch["transfusion_preds"],
                                              max_det=max_det)
        if "center_preds" in out_batch or "center_clip_preds" in out_batch \
                or "voxelnext_preds" in out_batch:
            return self.dense_head.get_bboxes(out_batch)
        return post_process(
            out_batch["batch_cls_preds"], out_batch["batch_box_preds"],
            *self._nms_args(),
            normalized=bool(out_batch.get("cls_preds_normalized", False)))

    def _nms_args(self):
        """POST_PROCESSING's NMS_THRESH, SCORE_THRESH, NMS_PRE_MAXSIZE and
        NMS_POST_MAXSIZE, as the post-processing functions take them."""
        pc = self.post_cfg
        nms_cfg = pc["NMS_CONFIG"]
        return (float(nms_cfg["NMS_THRESH"]),
                float(pc.get("SCORE_THRESH", 0.1)),
                int(nms_cfg.get("NMS_PRE_MAXSIZE", 1024)),
                int(nms_cfg.get("NMS_POST_MAXSIZE", 256)))


def build_detector(model_cfg, num_class, dataset, device=None):
    """dataset provides class_names, grid_size, voxel_size,
    point_cloud_range, num_point_features, max_voxels and
    max_points_per_voxel. Returns the module in eval mode on `device`
    (CUDA unless named; raises when CUDA is missing and none is named)."""
    from ... import resolve_device

    # a point-based dataset (PointRCNN's) voxelizes nothing: no grid
    grid_size = dataset.grid_size if dataset.grid_size is not None \
        else (1, 1, 1)
    voxel_size = dataset.voxel_size if dataset.voxel_size is not None \
        else (1.0, 1.0, 1.0)
    det = DetectorModule(
        model_cfg, num_class, tuple(dataset.class_names),
        grid_size, voxel_size, dataset.point_cloud_range,
        dataset.num_point_features, dataset.max_voxels,
        dataset.max_points_per_voxel)
    return det.to(resolve_device(device)).eval()
