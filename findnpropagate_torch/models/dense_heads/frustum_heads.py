"""Frustum query heads — port of
findnpropagate_tpu/models/dense_heads/frustum_heads.py
(`build_frustum_queries` :41, `ObjectPointsEncoder` :92, `FrustumViTHead`
:134, `FrustumPointNetHead` :192, `FrustumHeadTools` :263,
`make_frustum_head_tools` :360).

The queries come from cached 2D detections: per detection the lidar
points inside its image box, median-centred and evenly subsampled, built
on the host in numpy (`build_frustum_queries`), then fixed (B, P, N, 3)
slabs with validity masks. FrustumViTHead encodes each query's points
with a cls-token transformer, runs one encoder layer across the queries
and TransFusion-style separate heads; FrustumPointNetHead rotates each
frustum onto +x and runs Frustum PointNets v1, decoding its heading bins
and size anchors back into world boxes. Their targets and loss are
TransFusionHead's Hungarian machinery (`_assign`, `get_bboxes`) with a
world-coordinate box code and no dense-heatmap term (FrustumHeadTools).
Module names are the flax tree's (``encoder``, ``attn{d}``, ``xq_attn``,
``{name}_fc0`` / ``{name}_out``, ``fpointnet``; ObjectPointsEncoder's
``cls_token`` leaf). No yaml names these heads; the registry's signature
is taken and the widths read from the head's config.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils import losses as L
from ..frustum_pointnets import FrustumPointNetv1, decode_heading, decode_size
from ..model_utils.transformer import MultiHeadAttention
from .transfusion_head import TransFusionHead

LN_EPS = 1e-6
DEFAULT_PCR = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)


def build_frustum_queries(points, det_boxes, det_labels, det_scores,
                          det_cams, lidar2image, num_proposals=200,
                          max_points=256, min_points=5, score_thr=0.1,
                          image_size=(900, 1600)):
    """Per valid 2D detection (camera by camera, in detection order) the
    in-box lidar points, median-centred and evenly subsampled to at most
    max_points. numpy in, numpy out: query_pts (P, N, 3), query_pt_valid
    (P, N), query_pos (P, 3), query_labels (P,) 0-indexed, query_scores
    (P,), query_valid (P,)."""
    pts = np.asarray(points)[:, :3]
    h_img, w_img = image_size
    q_pts = np.zeros((num_proposals, max_points, 3), np.float32)
    q_ptv = np.zeros((num_proposals, max_points), bool)
    q_pos = np.zeros((num_proposals, 3), np.float32)
    q_lab = np.zeros(num_proposals, np.int64)
    q_sc = np.zeros(num_proposals, np.float32)
    q_val = np.zeros(num_proposals, bool)
    qi = 0
    for cam in sorted(set(int(c) for c in det_cams)):
        l2i = np.asarray(lidar2image[cam], np.float64)
        hom = pts @ l2i[:3, :3].T + l2i[:3, 3]
        depth = hom[:, 2]
        uv = hom[:, :2] / np.clip(depth[:, None], 1e-5, None)
        on_img = (depth > 1e-3) & (uv[:, 0] >= 0) & (uv[:, 0] < w_img) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < h_img)
        for i in range(len(det_boxes)):
            if int(det_cams[i]) != cam or det_scores[i] < score_thr:
                continue
            if qi >= num_proposals:
                break
            x1, y1, x2, y2 = det_boxes[i]
            on = (on_img & (uv[:, 0] >= x1) & (uv[:, 0] < x2)
                  & (uv[:, 1] >= y1) & (uv[:, 1] < y2))
            box_pts = pts[on]
            if len(box_pts) < min_points:
                continue
            med = np.median(box_pts, axis=0)
            n = min(max_points, len(box_pts))
            idx = np.linspace(0, len(box_pts) - 1, n).astype(np.int64)
            q_pts[qi, :n] = box_pts[idx] - med
            q_ptv[qi, :n] = True
            q_pos[qi] = med
            q_lab[qi] = int(det_labels[i]) - 1
            q_sc[qi] = float(det_scores[i])
            q_val[qi] = True
            qi += 1
    return dict(query_pts=q_pts, query_pt_valid=q_ptv, query_pos=q_pos,
                query_labels=np.maximum(q_lab, 0), query_scores=q_sc,
                query_valid=q_val)


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # flax's nn.gelu


class ObjectPointsEncoder(nn.Module):
    """Points normalised by their mean and variance, embedded, a cls-token
    pre-norm transformer over them; out the cls token + the mean and
    variance embeddings. x (B, N, 3), valid (B, N) -> (B, dim)."""

    FLAX_LEAVES = ("cls_token",)

    def __init__(self, dim: int = 64, depth: int = 2, heads: int = 8):
        super().__init__()
        self.depth = depth
        self.mean_emb = nn.Linear(3, dim)
        self.var_emb = nn.Linear(3, dim)
        self.point_emb = nn.Linear(3, dim)
        self.cls_token = nn.Parameter(torch.randn(1, dim))
        for d in range(depth):
            setattr(self, f"ln_a{d}", nn.LayerNorm(dim, eps=LN_EPS))
            setattr(self, f"attn{d}", MultiHeadAttention(dim, heads))
            setattr(self, f"ln_m{d}", nn.LayerNorm(dim, eps=LN_EPS))
            setattr(self, f"mlp{d}_0", nn.Linear(dim, dim))
            setattr(self, f"mlp{d}_1", nn.Linear(dim, dim))

    def forward(self, x, valid):
        m = valid[..., None].to(x.dtype)
        n = torch.clamp(m.sum(-2, keepdim=True), min=1.0)
        mean = (x * m).sum(-2, keepdim=True) / n
        var = ((x - mean) ** 2 * m).sum(-2, keepdim=True) / n
        mean_emb = self.mean_emb(mean[..., 0, :])
        var_emb = self.var_emb(var[..., 0, :])
        x = self.point_emb((x - mean) / (1e-8 + var)) * m
        tok = self.cls_token.to(x.dtype)[None].expand(x.shape[0], 1, -1)
        x = torch.cat([tok, x], dim=-2)
        av = torch.cat([torch.ones_like(valid[..., :1]), valid], dim=-1)
        mask = (av[:, None, :, None] & av[:, None, None, :])
        for d in range(self.depth):
            h = getattr(self, f"ln_a{d}")(x)
            x = x + getattr(self, f"attn{d}")(h, h, h, mask=mask)
            h = getattr(self, f"ln_m{d}")(x)
            h = getattr(self, f"mlp{d}_1")(_gelu(getattr(self,
                                                         f"mlp{d}_0")(h)))
            x = x + h
        return x[..., 0, :] + mean_emb + var_emb


def _query_inputs(batch):
    return (batch["query_pts"], batch["query_pt_valid"], batch["query_pos"],
            batch["query_labels"].long(), batch["query_scores"],
            batch["query_valid"])


class _FrustumHead(nn.Module):
    """The registry's signature; the tools (targets, loss, decode) of the
    head's config."""

    def __init__(self, model_cfg, num_class, class_names,
                 point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = int(num_class)
        self.tools = make_frustum_head_tools(
            model_cfg, num_class, class_names,
            DEFAULT_PCR if point_cloud_range is None else point_cloud_range)

    def compute_loss(self, out_batch):
        return self.tools.compute_loss(out_batch)

    def get_bboxes(self, res, max_det: int = 200):
        return self.tools.get_bboxes(res, max_det)


class FrustumViTHead(_FrustumHead):
    """Per query the ObjectPointsEncoder feature, one pre-norm encoder
    layer across the valid queries, and separate heads (centre and height
    relative to the query's median); the class score of the 2D detector
    rides in as one-hot x score. Reads the batch's query_* slabs."""

    HEADS = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2),
             ("vel", 2), ("heatmap", None))

    def __init__(self, model_cfg, input_channels=None, num_class=10,
                 class_names=(), point_cloud_range=None, voxel_size=None,
                 grid_size=None):
        super().__init__(model_cfg, num_class, class_names,
                         point_cloud_range)
        dim = int(model_cfg.get("HIDDEN_CHANNEL", 64))
        self.encoder = ObjectPointsEncoder(dim=dim)
        self.xq_ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.xq_attn = MultiHeadAttention(dim, 8)
        self.xq_ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.xq_mlp0 = nn.Linear(dim, dim)
        self.xq_mlp1 = nn.Linear(dim, dim)
        for name, out in self.HEADS:
            setattr(self, f"{name}_fc0", nn.Linear(dim, 64))
            setattr(self, f"{name}_out",
                    nn.Linear(64, self.num_class if out is None else out))

    def _head(self, name, feat):
        return getattr(self, f"{name}_out")(torch.relu(
            getattr(self, f"{name}_fc0")(feat)))

    def forward(self, batch, generator=None):
        q_pts, q_ptv, q_pos, q_lab, q_sc, q_val = _query_inputs(batch)
        b, p, n, _ = q_pts.shape
        feat = self.encoder(q_pts.reshape(b * p, n, 3),
                            q_ptv.reshape(b * p, n)).reshape(b, p, -1)
        qmask = q_val[:, None, :, None] & q_val[:, None, None, :]
        h = self.xq_ln(feat)
        feat = feat + self.xq_attn(h, h, h, mask=qmask)
        h = self.xq_mlp0(self.xq_ln2(feat))
        feat = feat + self.xq_mlp1(_gelu(h))
        one_hot = F.one_hot(q_lab, self.num_class).to(feat.dtype)
        res = {name: self._head(name, feat) for name, _ in self.HEADS}
        res["center"] = res["center"] + q_pos[..., :2]
        res["height"] = res["height"] + q_pos[..., 2:3]
        res.update(stage1_center=q_pos, query_labels=q_lab,
                   query_heatmap_score=one_hot * q_sc[..., None],
                   query_valid=q_val)
        batch["transfusion_preds"] = res
        return batch


class FrustumPointNetHead(_FrustumHead):
    """Each frustum rotated so its query centre lies on +x, Frustum
    PointNets v1 with the class one-hot, the centres and headings rotated
    back; the heatmap is the logit of the 2D detector's score."""

    SIZE_ANCHORS = ((4.63, 1.97, 1.74), (1.70, 0.60, 1.28),
                    (0.73, 0.67, 1.77))

    def __init__(self, model_cfg, input_channels=None, num_class=10,
                 class_names=(), point_cloud_range=None, voxel_size=None,
                 grid_size=None, size_anchors=SIZE_ANCHORS):
        super().__init__(model_cfg, num_class, class_names,
                         point_cloud_range)
        self.register_buffer("size_anchors", torch.tensor(
            size_anchors, dtype=torch.float32), persistent=False)
        self.fpointnet = FrustumPointNetv1(
            self.num_class, int(model_cfg.get("NUM_HEADING_BIN", 12)),
            tuple(map(tuple, size_anchors)))

    def forward(self, batch, generator=None):
        q_pts, q_ptv, q_pos, q_lab, q_sc, q_val = _query_inputs(batch)
        b, p, n, _ = q_pts.shape
        prerot = torch.atan2(q_pos[..., 1], q_pos[..., 0])       # (B, P)
        c, s = torch.cos(-prerot)[..., None], torch.sin(-prerot)[..., None]
        world = q_pts + q_pos[..., None, :]
        rot_pts = torch.stack([world[..., 0] * c - world[..., 1] * s,
                               world[..., 0] * s + world[..., 1] * c,
                               world[..., 2]], -1)
        one_hot = F.one_hot(q_lab, self.num_class).to(q_pts.dtype)
        out = self.fpointnet(rot_pts.reshape(b * p, n, 3),
                             one_hot.reshape(b * p, -1),
                             q_ptv.reshape(b * p, n))
        out = {k: v.reshape(b, p, *v.shape[1:]) for k, v in out.items()}
        heading = decode_heading(out["heading_scores"], out["heading_res"],
                                 prerot)
        size = decode_size(out["size_scores"], out["size_res"],
                           self.size_anchors.to(q_pts.dtype))
        cc, cs = torch.cos(prerot), torch.sin(prerot)
        ctr = out["center"]
        score = one_hot * q_sc[..., None]
        batch["transfusion_preds"] = {
            "center": torch.stack([ctr[..., 0] * cc - ctr[..., 1] * cs,
                                   ctr[..., 0] * cs + ctr[..., 1] * cc], -1),
            "height": ctr[..., 2:3],
            "dim": torch.log(torch.clamp(size, min=1e-5)),
            "rot": torch.stack([torch.sin(heading), torch.cos(heading)], -1),
            "heatmap": torch.log(torch.clamp(score, min=1e-5)
                                 / torch.clamp(1 - score, min=1e-5)),
            "query_labels": q_lab, "query_heatmap_score": score,
            "query_valid": q_val, "fpointnet_out": out, "prerot": prerot}
        return batch


class FrustumHeadTools:
    """TransFusionHead's Hungarian targets and detections with the frustum
    heads' world-coordinate box code (raw x, y, z, log dims, sin / cos,
    the velocity where the code is 10 wide) and no dense-heatmap loss; the
    padded query slots carry no loss."""

    code_size = TransFusionHead.code_size
    _iou3d_bottom = staticmethod(TransFusionHead._iou3d_bottom)
    _is_unknown = TransFusionHead._is_unknown
    _assign = TransFusionHead._assign
    get_bboxes = TransFusionHead.get_bboxes

    def __init__(self, model_cfg, num_classes, point_cloud_range,
                 class_names=()):
        self.model_cfg = model_cfg
        self.num_classes = int(num_classes)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.class_names = tuple(class_names)
        self.unknown_labels = ()

    def decode_boxes(self, res):
        rot = torch.atan2(res["rot"][..., 0], res["rot"][..., 1])
        parts = [res["center"][..., :2], res["height"], torch.exp(res["dim"]),
                 rot[..., None]]
        if "vel" in res:
            parts.append(res["vel"])
        return torch.cat(parts, dim=-1)

    def encode_gt(self, gt_boxes):
        out = [gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2],
               torch.log(torch.clamp(gt_boxes[..., 3], min=1e-5)),
               torch.log(torch.clamp(gt_boxes[..., 4], min=1e-5)),
               torch.log(torch.clamp(gt_boxes[..., 5], min=1e-5)),
               torch.sin(gt_boxes[..., 6]), torch.cos(gt_boxes[..., 6])]
        if self.code_size == 10:
            out.extend([gt_boxes[..., 7], gt_boxes[..., 8]])
        return torch.stack(out, dim=-1)

    @torch.no_grad()
    def get_targets(self, res, gt_boxes_with_cls):
        gt = gt_boxes_with_cls[..., :-1]
        gt_labels = torch.clamp(gt_boxes_with_cls[..., -1].long() - 1, min=0)
        gt_valid = ((gt_boxes_with_cls[..., -1] > 0) & (gt[..., 3] > 0)
                    & (gt[..., 4] > 0))
        keys = [k for k in ("center", "height", "dim", "rot", "vel",
                            "heatmap") if k in res]
        labels, lw, bt, bw, npos, ious, unk = self._assign(
            {k: res[k].detach() for k in keys}, gt, gt_labels, gt_valid)
        if "query_valid" in res:
            qv = res["query_valid"]
            lw = lw * qv.to(lw.dtype)
            bw = bw * qv[..., None].to(bw.dtype)
        return {"labels": labels, "label_weights": lw, "bbox_targets": bt,
                "bbox_weights": bw, "num_pos": npos, "ious": ious,
                "unknown_mask": unk}

    def loss(self, batch, targets=None):
        """(total, tb): the sigmoid focal class loss and the L1 box loss
        over the matched queries."""
        res = batch["transfusion_preds"]
        lw_cfg = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        cls_cfg = self.model_cfg["LOSS_CONFIG"]["LOSS_CLS"]
        if targets is None:
            targets = self.get_targets(res, batch["gt_boxes"])
        labels = targets["labels"].reshape(-1)
        num_pos = torch.clamp(targets["num_pos"], min=1)
        cls_score = res["heatmap"].reshape(-1, self.num_classes)
        one_hot = F.one_hot(labels, self.num_classes + 1)[..., :-1].to(
            cls_score.dtype)
        loss_cls = L.sigmoid_focal_loss(
            cls_score, one_hot, targets["label_weights"].reshape(-1),
            gamma=float(cls_cfg.get("gamma", 2.0)),
            alpha=float(cls_cfg.get("alpha", 0.25))).sum() / num_pos
        preds = torch.cat([res[k] for k in ("center", "height", "dim", "rot",
                                            "vel") if k in res], dim=-1)
        preds = preds[..., :self.code_size]
        cw = torch.tensor(lw_cfg["code_weights"], dtype=preds.dtype,
                          device=preds.device)
        loss_bbox = ((preds - targets["bbox_targets"]).abs()
                     * targets["bbox_weights"] * cw).sum() / num_pos
        total = loss_cls * float(lw_cfg.get("cls_weight", 1.0)) \
            + loss_bbox * float(lw_cfg.get("bbox_weight", 0.25))
        matched = labels < self.num_classes
        with torch.no_grad():
            tb = {"loss_cls": loss_cls.detach(),
                  "loss_bbox": loss_bbox.detach(),
                  "matched_ious": torch.where(
                      matched, targets["ious"].reshape(-1),
                      torch.zeros((), dtype=preds.dtype)).sum()
                  / torch.clamp(matched.sum(), min=1),
                  "loss_trans": total.detach()}
        return total, tb

    def compute_loss(self, out_batch):
        return self.loss(out_batch)


def make_frustum_head_tools(model_cfg, num_class, class_names=(),
                            point_cloud_range=DEFAULT_PCR):
    return FrustumHeadTools(model_cfg,
                            int(model_cfg.get("NUM_CLASSES", num_class)),
                            point_cloud_range, class_names)
