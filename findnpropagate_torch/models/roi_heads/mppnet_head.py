"""MPPNet: multi-frame proposal refinement over proposal trajectories —
port of findnpropagate_tpu/models/roi_heads/mppnet_head.py (the geometry
helpers :48-197, `MPPNetHead` :199-460, `mppnet_loss` :467-548, the
streaming path :556-801).

Every function takes the batch axis first (the reference vmaps
per-sample functions):
  * trajectories: F-1 steps of batched rotated IoU, the velocity-
    propagated box of frame i-1 against frame i's proposals, matched
    greedily by the first argmax and valid at IoU >= 0.5 (and where frame
    0 is valid); an unmatched frame keeps the propagated box;
  * ROI noise augmentation: `aug_times` candidates a ROI, the first whose
    IoU with its ground truth reaches the threshold, else the last. The
    uniform draws are arguments (`aug_draws` makes them from a
    torch.Generator), so the tests hand in the reference's;
  * point cropping: the first K points in index order inside each box's
    BEV cylinder, ranked among the hits that `nonzero` lists instead of
    the reference's top-k over an (M, N) key, in chunks of ROIs so that
    no (M, N) float array of a 160-ROI, 800k-point sample is ever whole;
    the empty slots hold the first hit, an empty crop zeros;
  * proxy pooling: the port's SALayer over the (B*S*F) axis.
The module names are the flax tree's, so utils/weights.py carries a
trained tree across, and MPPNetHeadE2E has MPPNetHead's modules: an
offline checkpoint loads into the streaming head.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.rotated_iou import boxes_aligned_iou3d, boxes_iou3d
from ...parallel.mesh import all_sum
from ...utils.box_coders import ResidualCoder
from ...utils.geometry import rotate_points_along_z
from ...utils.losses import corner_loss_lidar, smooth_l1
from ..model_utils.mppnet_utils import (
    MLPStack,
    MPPNetTransformer,
    SeqBoxPointNet,
)
from ..pfe.voxel_set_abstraction import SALayer
from .roi_head_template import (
    _roi_anchors,
    _to_lidar,
    canonicalize_gt_of_rois,
    generate_predicted_boxes,
    sample_rois_for_rcnn,
)

# the elements of one chunk's (B, ROIs, points) hit mask in the crop
CROP_CHUNK_ELEMS = 1 << 25


# ---------------------------------------------------------------- geometry

def _unit_corners(like):
    return torch.tensor([[i, j, k] for i in (0.0, 1.0) for j in (0.0, 1.0)
                         for k in (0.0, 1.0)], dtype=like.dtype,
                        device=like.device)


def _grid_index(g, like):
    return torch.tensor([[i, j, k] for i in range(g) for j in range(g)
                         for k in range(g)], dtype=like.dtype,
                        device=like.device)


def _box_local_to_global(local, boxes):
    """local (..., P, 3) offsets in each box's frame -> global."""
    shape = local.shape
    rot = rotate_points_along_z(local.reshape(-1, shape[-2], 3),
                                boxes[..., 6].reshape(-1)).reshape(shape)
    return rot + boxes[..., None, 0:3]


def box_anchor_points(boxes):
    """The 8 corners and the centre of each box. (..., 7) -> (..., 9, 3)."""
    lwh = boxes[..., 3:6]
    local = _unit_corners(boxes) * lwh[..., None, :] \
        - lwh[..., None, :] / 2.0
    corners = _box_local_to_global(local, boxes)
    return torch.cat([corners, boxes[..., None, 0:3]], dim=-2)


def spherical_offsets(points, anchors, diag):
    """Offsets of points (..., P, 3) to the 9 anchors (..., 9, 3) in
    spherical form, the distance over the box diagonal diag (...) ->
    (..., P, 27) = [dis * 9, phi * 9, theta * 9]."""
    rel = points[..., :, None, :] - anchors[..., None, :, :]
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    dis = torch.sqrt(x * x + y * y + z * z)
    phi = torch.atan(y / (x + 1e-5))
    theta = torch.acos(torch.clamp(z / (dis + 1e-5), -1.0, 1.0))
    dis = dis / (diag[..., None, None] + 1e-5)
    return torch.cat([dis, phi, theta], dim=-1)


def proxy_grid_points(boxes, grid_size: int):
    """The dense grid^3 proxy points of each box, x-major. (..., 7) ->
    (..., G, 3)."""
    g = grid_size
    lwh = boxes[..., 3:6]
    local = (_grid_index(g, boxes) + 0.5) / g * lwh[..., None, :] \
        - lwh[..., None, :] / 2.0
    return _box_local_to_global(local, boxes)


def generate_trajectory(proposals, proposals_valid, iou_thresh: float = 0.5):
    """proposals (B, F, R, C>=9) frame-major (frame 0 current), channels
    [x y z dx dy dz ry vx vy ...]; proposals_valid (B, F, R). Returns
    (trajectory (B, F, R, C), valid (B, F, R), assignment (B, F, R) int64:
    the matched proposal of each frame)."""
    b, f, r, c = proposals.shape
    traj = [proposals[:, 0]]
    valid = [proposals_valid[:, 0]]
    assigns = [torch.arange(r, device=proposals.device).expand(b, r)]
    for i in range(1, f):
        prev = traj[-1]
        pred = torch.cat([prev[..., 0:2] + prev[..., 7:9], prev[..., 2:]],
                         dim=-1)
        iou = boxes_iou3d(pred[..., :7], proposals[:, i, :, :7])
        iou = torch.where(proposals_valid[:, i, None, :], iou,
                          torch.zeros_like(iou))
        best = iou.amax(dim=-1)
        assign = torch.argmax(iou, dim=-1)       # the first of equal maxima
        ok = best >= iou_thresh
        matched = torch.gather(proposals[:, i], 1,
                               assign[..., None].expand(b, r, c))
        traj.append(torch.where(ok[..., None], matched, pred))
        valid.append(ok & valid[0])
        assigns.append(assign)
    return (torch.stack(traj, 1), torch.stack(valid, 1),
            torch.stack(assigns, 1))


# ------------------------------------------------------ ROI augmentation

def aug_draws(batch: int, aug_times: int, m: int, generator=None,
              device=None):
    """The uniforms of `aug_rois_parallel` for (B, T, M) candidates: the
    centre shift in [-0.5, 0.5), the size factor in [0.85, 1.15), the
    heading shift in [-pi/12, pi/12) and the keep draw in [0, 1)."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)
    return (u(batch, aug_times, m, 3) - 0.5,
            1.0 + (u(batch, aug_times, m, 3) * 0.3 - 0.15),
            u(batch, aug_times, m, 1) * (math.pi / 6) - math.pi / 12,
            u(batch, aug_times, m))


def aug_rois_parallel(draws, rois, gt_boxes, src_iou, keep_ratio: float,
                      pos_thresh: float):
    """The reference's noise loop made parallel: T candidates a ROI (each
    the ROI itself where its keep draw <= keep_ratio), the first whose IoU
    with the paired gt reaches pos_thresh, else the last. draws: (pos,
    scale, rot, keep_u) of shapes (B, T, M, 3 / 3 / 1 / -); rois / gt
    (B, M, 7); src_iou (B, M). Returns (rois (B, M, 7), ious (B, M))."""
    pos, scale, rot, keep_u = draws
    t = keep_u.shape[1]
    keep = keep_u <= keep_ratio
    r = rois[:, None]
    cand = torch.cat([r[..., 0:3] + pos, r[..., 3:6] * scale,
                      r[..., 6:7] + rot], dim=-1)
    cand = torch.where(keep[..., None], r.expand_as(cand), cand)
    iou = boxes_aligned_iou3d(cand, gt_boxes[:, None, :, :7].expand_as(cand))
    iou = torch.where(keep, src_iou[:, None].expand_as(iou), iou)
    hit = iou >= pos_thresh                                 # (B, T, M)
    first = torch.argmax(hit.to(torch.int8), dim=1)
    pick = torch.where(hit.any(dim=1), first, torch.full_like(first, t - 1))
    sel = torch.gather(cand, 1, pick[:, None, :, None].expand(
        -1, 1, -1, cand.shape[-1]))[:, 0]
    return sel, torch.gather(iou, 1, pick[:, None])[:, 0]


# -------------------------------------------------------------- cropping

def crop_points_to_rois(points, points_mask, boxes, num_sample: int):
    """The first `num_sample` points, in point order, inside each box's
    cylinder of radius 1.1 x its BEV half-diagonal. points (B, N, C);
    points_mask (B, N); boxes (B, M, 7+). Returns (crop (B, M, K, C),
    valid (B, M, K)): the empty slots hold the first hit, a box without
    hits zeros. A hit's slot is its rank among its box's hits: the hits
    of a chunk come out of `nonzero` in (box, point) order, so the rank is
    the hit's position less its box's first."""
    b, n, c = points.shape
    m, k = boxes.shape[1], num_sample
    dev = points.device
    radii = torch.sqrt((boxes[..., 3] / 2) ** 2
                       + (boxes[..., 4] / 2) ** 2) * 1.1
    r2 = radii ** 2
    rows = max(1, CROP_CHUNK_ELEMS // max(1, b * n))
    idx = torch.zeros(b, m, k, dtype=torch.long, device=dev)
    count = torch.zeros(b, m, dtype=torch.long, device=dev)
    for s in range(0, m, rows):
        bx = boxes[:, s:s + rows]
        mc = bx.shape[1]
        d2 = (points[:, None, :, 0] - bx[..., 0, None]) ** 2 \
            + (points[:, None, :, 1] - bx[..., 1, None]) ** 2
        ok = (d2 <= r2[:, s:s + rows, None]) & points_mask[:, None, :]
        del d2
        cnt = ok.sum(dim=-1)                                  # (B, mc)
        hb, hm, hn = torch.nonzero(ok, as_tuple=True)
        first = (torch.cumsum(cnt.flatten(), 0) - cnt.flatten())[
            hb * mc + hm]
        rank = torch.arange(hb.numel(), device=dev) - first
        keep = rank < k
        idx[hb[keep], s + hm[keep], rank[keep]] = hn[keep]
        count[:, s:s + rows] = cnt
    valid = torch.arange(k, device=dev) < count[..., None]
    idx = torch.where(valid, idx, idx[..., :1])
    crop = torch.gather(points[:, None].expand(b, m, n, c), 2,
                        idx[..., None].expand(b, m, k, c))
    crop = torch.where((count > 0)[..., None, None], crop,
                       torch.zeros_like(crop))
    return crop, valid


# -------------------------------------------------------------- the head

def _take_rois(x, take):
    """x (B, F, R, ...) at take (B, S) along R -> (B, F, S, ...)."""
    idx = take.long()[:, None, :].reshape(
        take.shape[0], 1, take.shape[1], *([1] * (x.ndim - 3)))
    return torch.gather(x, 2, idx.expand(x.shape[0], x.shape[1],
                                         take.shape[1], *x.shape[3:]))


class MPPNetHead(nn.Module):
    """Refines the current frame's boxes from per-frame proposals (batch
    keys ``roi_boxes`` (B, F, R, 9), ``roi_scores`` / ``roi_labels``
    (B, F, R)) and the multi-frame cloud (``points`` (B, N, C) with a
    trailing time channel, ``points_mask``). In training ``gt_boxes``
    (B, G, 8) too, and optionally the draws ``mppnet_draws`` ({"roi": (B,
    R), "aug": aug_draws(...), "traj": [aug_draws(...) of frames 1..F-1]});
    missing draws come from the generator."""

    def __init__(self, model_cfg, point_cloud_range=(), voxel_size=(),
                 num_class: int = 1, num_point_features: int = 6):
        super().__init__()
        self.model_cfg = cfg = model_cfg
        tcfg = cfg["Transformer"]
        self.num_frames = int(tcfg["num_frames"])
        self.num_groups = int(tcfg["num_groups"])
        self.p_pts = int(tcfg["num_lidar_points"])
        self.g_pts = int(tcfg["num_proxy_points"])
        self.grid = int(cfg["ROI_GRID_POOL"]["GRID_SIZE"])
        self.hidden = hidden = int(cfg["TRANS_INPUT"])
        self.use_ts = bool(cfg.get("USE_TIMESTAMP", False))
        self.num_class = int(num_class)
        self.coder = ResidualCoder()
        code = self.coder.code_size
        feat_dim = num_point_features if self.use_ts \
            else num_point_features - 1
        pool = cfg["ROI_GRID_POOL"]
        num_radius = len(pool["POOL_RADIUS"])
        self.up_dimension_geometry = MLPStack(27 + feat_dim - 3, 64,
                                              hidden // num_radius, 3)
        self.roi_grid_pool = SALayer(hidden // num_radius, pool["MLPS"],
                                     pool["POOL_RADIUS"], pool["NSAMPLE"])
        self.up_dimension_motion = MLPStack(30, 64, hidden, 3)
        self.seqboxembed = SeqBoxPointNet(cfg, code)
        self.use_grid_pos = bool(tcfg.get("use_grid_pos", {}).get(
            "enabled", False))
        if self.use_grid_pos:
            self.grid_pos_embeded = MLPStack(3, 256, hidden, 2)
        self.transformer = MPPNetTransformer(tcfg, self.grid)
        d = int(tcfg["hidden_dim"])
        self.class_embed = nn.Linear(d, 1)
        for gi in range(self.num_groups):
            setattr(self, f"bbox_embed_{gi}",
                    MLPStack(d, d, code * self.num_class, 4))
        self.jointembed = MLPStack(self.num_groups * d + hidden, d,
                                   code * self.num_class, 4)

    # ---- shared pieces ---------------------------------------------------

    def _feat_dim(self, pts):
        return pts.shape[-1] if self.use_ts else pts.shape[-1] - 1

    def _geometry_in(self, pts_xyz_extra, anchor9, diag):
        return self.up_dimension_geometry(torch.cat(
            [spherical_offsets(pts_xyz_extra[..., :3], anchor9, diag),
             pts_xyz_extra[..., 3:]], dim=-1))

    def _pool(self, proxies, src_xyz, src_valid, geo):
        """proxies (N, G, 3), src (N, P, 3) -> (N, G, hidden)."""
        return self.roi_grid_pool(
            proxies, torch.ones(proxies.shape[:2], dtype=torch.bool,
                                device=proxies.device),
            src_xyz, src_valid, geo)

    def _motion(self, prox_flat, anchor0, diag0):
        b, s, fg, _ = prox_flat.shape
        f = self.num_frames
        tstamp = torch.repeat_interleave(
            torch.arange(f, dtype=prox_flat.dtype, device=prox_flat.device)
            * 0.1, self.g_pts)
        return self.up_dimension_motion(torch.cat(
            [spherical_offsets(prox_flat, anchor0, diag0),
             prox_flat.new_zeros(b, s, fg, 2),
             tstamp[None, None, :, None].expand(b, s, fg, 1)], dim=-1))

    def _box_branch(self, traj):
        """traj (B, F, S, C) -> (box_reg (B*S, code), box_feat)."""
        b, f, s, _ = traj.shape
        tstep = torch.arange(f, dtype=traj.dtype,
                             device=traj.device)[:, None] * 0.1
        box_seq = torch.cat([traj[..., :7], tstep[None, :, None].expand(
            b, f, s, 1)], dim=-1)
        box_seq = torch.cat([box_seq[..., 0:3] - box_seq[:, 0:1, :, 0:3],
                             box_seq[..., 3:]], dim=-1)
        ry0 = torch.remainder(box_seq[:, 0, :, 6], 2 * math.pi)
        flat = box_seq.transpose(1, 2).reshape(b * s, f, 8)
        xyz = rotate_points_along_z(flat[..., 0:3], -ry0.reshape(-1))
        flat = torch.cat([xyz, flat[..., 3:6], torch.zeros_like(
            flat[..., 6:7]), flat[..., 7:8]], dim=-1)
        return self.seqboxembed(flat)

    def _grid_pos(self, like):
        if not self.use_grid_pos:
            return None
        return self.grid_pos_embeded(_grid_index(self.grid, like))

    def _refine(self, feats, box_feat, generator):
        """feats (B*S, F*G, hidden) -> (point_cls (L, BS, 1), tokens, hs,
        joint_reg (BS, code))."""
        hs, tokens = self.transformer(feats, self._grid_pos(feats),
                                      generator)
        point_cls = self.class_embed(tokens[:, :, 0])
        joint_reg = self.jointembed(torch.cat([hs, box_feat], dim=-1))
        return point_cls, tokens, joint_reg

    def _decode(self, batch, rois, extra, rcnn_reg, rcnn_cls, stage1,
                roi_labels):
        """The boxes (the ROIs' columns `extra` appended) and the scores,
        blended with the first stage's under AVG_STAGE1_SCORE."""
        batch["batch_box_preds"] = torch.cat(
            [generate_predicted_boxes(rois[..., :7], rcnn_reg, self.coder),
             extra], dim=-1)
        score = torch.sigmoid(rcnn_cls)
        cfg = self.model_cfg
        if bool(cfg.get("AVG_STAGE1_SCORE", False)):
            stage1 = torch.clamp(stage1, 1e-6, 1.0)
            iou_w = cfg.get("IOU_WEIGHT")
            if iou_w is not None:
                w_car, w_ped = float(iou_w[0]), float(iou_w[1])
                score = torch.where(
                    roi_labels == 1,
                    score ** w_car * stage1 ** (1.0 - w_car),
                    score ** w_ped * stage1 ** (1.0 - w_ped))
            else:
                score = torch.sqrt(score * stage1)
        batch["batch_cls_preds"] = score[..., None]
        batch["cls_preds_normalized"] = True
        batch["batch_roi_labels"] = roi_labels
        return batch

    # ---- training targets ----------------------------------------------

    @torch.no_grad()
    def _sample(self, batch, traj, valid_len, scores0, labels0, generator):
        cfg = self.model_cfg["TARGET_CONFIG"]
        gt = batch["gt_boxes"]
        b, f, r, _ = traj.shape
        draws = batch.get("mppnet_draws", {})
        rd = draws.get("roi")
        if rd is None:
            rd = torch.rand(b, r, generator=generator, device=traj.device)
        out = sample_rois_for_rcnn(
            rd.to(traj.dtype), traj[:, 0], scores0, labels0, valid_len[:, 0],
            gt[..., :7], gt[..., -1].to(torch.int64), gt[..., -1] > 0, cfg)
        take = out["take"]
        s_traj = _take_rois(traj, take)
        s_vlen = _take_rois(valid_len, take)
        s = take.shape[1]
        times = int(cfg.get("ROI_FG_AUG_TIMES", 10))
        ratio = float(cfg.get("RATIO", 0.2))
        fg = out["reg_valid_mask"]
        if bool(cfg.get("USE_ROI_AUG", False)):
            d = draws.get("aug") or aug_draws(b, times, s, generator,
                                              traj.device)
            aug, aug_iou = aug_rois_parallel(
                d, out["rois"][..., :7], out["gt_of_rois_src"][..., :7],
                out["gt_iou_of_rois"], ratio,
                min(float(cfg["REG_FG_THRESH"]), float(cfg["CLS_FG_THRESH"])))
            rois7 = torch.where(fg[..., None], aug, out["rois"][..., :7])
            out["rois"] = torch.cat([rois7, out["rois"][..., 7:]], dim=-1)
            out["gt_iou_of_rois"] = torch.where(fg, aug_iou,
                                                out["gt_iou_of_rois"])
        frames = [out["rois"]]
        if bool(cfg.get("USE_TRAJ_AUG", {}).get("ENABLED", False)):
            thr = float(cfg["USE_TRAJ_AUG"]["THRESHOD"])
            given = draws.get("traj")
            for fi in range(1, f):
                d = given[fi - 1] if given is not None else aug_draws(
                    b, times, s, generator, traj.device)
                a, _ = aug_rois_parallel(
                    d, s_traj[:, fi, :, :7], s_traj[:, fi, :, :7],
                    torch.ones_like(out["gt_iou_of_rois"]), ratio, thr)
                frames.append(torch.where(
                    fg[..., None], torch.cat([a, s_traj[:, fi, :, 7:]], -1),
                    s_traj[:, fi]))
        else:
            frames += [s_traj[:, fi] for fi in range(1, f)]
        return out, torch.stack(frames, 1), s_vlen

    # ---- forward ---------------------------------------------------------

    def forward(self, batch, generator=None):
        f, p_pts, g_pts = self.num_frames, self.p_pts, self.g_pts
        hidden, code = self.hidden, self.coder.code_size
        proposals = batch["roi_boxes"]
        b, nf, r, pc = proposals.shape
        if nf != f:
            raise ValueError(f"roi_boxes holds {nf} frames, the head "
                             f"{f}")
        with torch.no_grad():
            prop_valid = proposals[..., :6].abs().sum(-1) > 0
            traj, valid_len, _ = generate_trajectory(proposals, prop_valid)
        scores0 = batch["roi_scores"][:, 0]
        labels0 = batch["roi_labels"][:, 0].long()
        targets = None
        if self.training:
            targets, traj, valid_len = self._sample(
                batch, traj, valid_len, scores0, labels0, generator)
            rois, roi_labels = targets["rois"], targets["roi_labels"]
            roi_valid = targets["roi_valid"]
        else:
            rois, roi_labels, roi_valid = traj[:, 0], labels0, \
                prop_valid[:, 0]
        s = rois.shape[1]
        empty_mask = rois[..., :6].abs().sum(-1) <= 0

        pts, pmask = batch["points"], batch["points_mask"]
        t = pts[..., -1]
        feat_dim = self._feat_dim(pts)
        crops, crop_valid = [], []
        with torch.no_grad():
            for fi in range(f):
                m = pmask if fi == 0 \
                    else pmask & ((t - fi * 0.1).abs() < 1e-3)
                c, v = crop_points_to_rois(pts, m, traj[:, fi, :, :7], p_pts)
                crops.append(c[..., :feat_dim])
                crop_valid.append(v)
        src = torch.stack(crops, 2)                          # (B,S,F,P,C)
        src_valid = torch.stack(crop_valid, 2)
        keep = valid_len.transpose(1, 2)[..., None]           # (B,S,F,1)
        src = torch.where(keep[..., None], src, src[:, :, :1])
        src_valid = torch.where(keep, src_valid, src_valid[:, :, :1])

        t7 = traj[..., :7]
        anchor9 = box_anchor_points(t7).transpose(1, 2)       # (B,S,F,9,3)
        diag = torch.linalg.norm(traj[..., 3:6], dim=-1).transpose(1, 2)
        geo = self._geometry_in(src, anchor9, diag)
        proxies = proxy_grid_points(t7.transpose(1, 2), self.grid)
        bsf = b * s * f
        pooled = self._pool(proxies.reshape(bsf, g_pts, 3),
                            src[..., :3].reshape(bsf, p_pts, 3),
                            src_valid.reshape(bsf, p_pts),
                            geo.reshape(bsf, p_pts, -1))
        geo_feat = pooled.reshape(b, s, f * g_pts, hidden)
        motion = self._motion(proxies.reshape(b, s, f * g_pts, 3),
                              anchor9[:, :, 0], diag[:, :, 0])
        feats = geo_feat + motion
        if bool(self.model_cfg.get("USE_TRAJ_EMPTY_MASK", False)):
            feats = torch.where(empty_mask[..., None, None],
                                torch.zeros_like(feats), feats)
        box_reg, box_feat = self._box_branch(traj)
        point_cls, tokens, joint_reg = self._refine(
            feats.reshape(b * s, f * g_pts, hidden), box_feat, generator)
        layers = tokens.shape[0]
        point_reg = torch.stack([getattr(self, f"bbox_embed_{gi}")(
            tokens[:, :, gi]) for gi in range(self.num_groups)], 0)
        rcnn_cls = point_cls[-1].reshape(b, s)
        rcnn_reg = joint_reg.reshape(b, s, code)

        batch["rois"] = rois
        batch["roi_labels"] = roi_labels
        batch["roi_valid"] = roi_valid & ~empty_mask
        batch["mppnet_preds"] = {
            "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
            "point_cls": point_cls.reshape(layers, b, s),
            "point_reg": point_reg.reshape(self.num_groups, layers, b, s,
                                           code),
            "box_reg": box_reg.reshape(b, s, code)}
        if self.training:
            batch["mppnet_targets"] = targets
        stage1 = targets["roi_scores"] if self.training else scores0
        return self._decode(batch, rois, rois[..., 7:], rcnn_reg, rcnn_cls,
                            stage1, roi_labels)


def mppnet_loss(out_batch, model_cfg):
    """The ROI head's loss alone (the MPPNet detector has no first stage
    inside): the regression of the joint head, the groups' and layers'
    auxiliary regressions and the box branch's (USE_AUX_LOSS), the corner
    loss, and the binary cross entropy of every layer's token. (loss,
    tb)."""
    cfg = model_cfg["ROI_HEAD"] if "ROI_HEAD" in model_cfg else model_cfg
    loss_cfg = cfg["LOSS_CONFIG"]
    weights = loss_cfg["LOSS_WEIGHTS"]
    coder = ResidualCoder()
    code = coder.code_size
    preds, tgt = out_batch["mppnet_preds"], out_batch["mppnet_targets"]
    rois = tgt["rois"]
    gt_src = tgt["gt_of_rois_src"][..., :code]
    reg_valid = tgt["reg_valid_mask"].reshape(-1)
    cls_labels = tgt["rcnn_cls_labels"].reshape(-1)

    gt_ct = canonicalize_gt_of_rois(rois[..., :7], gt_src).reshape(-1, code)
    anchors = _roi_anchors(rois[..., :7]).reshape(-1, code)
    reg_targets = coder.encode(gt_ct, anchors)
    cw = torch.as_tensor(weights["code_weights"], dtype=torch.float32,
                         device=rois.device)
    fg = reg_valid.to(torch.float32)
    n_fg, n_valid = all_sum(fg.sum(), (cls_labels >= 0).sum().float())
    n_fg = torch.clamp(n_fg, min=1.0)

    def reg_term(pred_flat):
        l1 = smooth_l1(pred_flat - reg_targets, beta=1.0 / 9.0) * cw
        return (l1.sum(-1) * fg).sum() / n_fg

    rw = float(weights["rcnn_reg_weight"])
    tw = [float(x) for x in weights.get("traj_reg_weight", (1.0, 1.0, 1.0))]
    loss_reg = reg_term(preds["rcnn_reg"].reshape(-1, code)) * rw * tw[0]
    tb = {"rcnn_loss_reg": loss_reg}
    if bool(cfg.get("USE_AUX_LOSS", False)):
        pr = preds["point_reg"]
        ng, layers = pr.shape[0], pr.shape[1]
        aux = sum(reg_term(pr[gi, li].reshape(-1, code))
                  for gi in range(ng) for li in range(layers))
        aux = aux / (ng * layers) * rw * tw[2]
        tb["point_loss_reg"] = aux
        seq = reg_term(preds["box_reg"].reshape(-1, code)) * rw * tw[1]
        tb["seqbox_loss_reg"] = seq
        loss_reg = loss_reg + aux + seq
    if bool(loss_cfg.get("CORNER_LOSS_REGULARIZATION", False)):
        dec = _to_lidar(coder.decode(preds["rcnn_reg"].reshape(-1, code),
                                     anchors), rois[..., :7].reshape(-1, 7))
        cl = corner_loss_lidar(dec[:, :7], gt_src.reshape(-1, code)[:, :7])
        closs = (cl * fg).sum() / n_fg * float(weights["rcnn_corner_weight"])
        tb["rcnn_loss_corner"] = closs
        loss_reg = loss_reg + closs

    pcls = preds["point_cls"]
    valid = (cls_labels >= 0).to(torch.float32)
    n_valid = torch.clamp(n_valid, min=1.0)
    loss_cls = 0.0
    for li in range(pcls.shape[0]):
        p = torch.sigmoid(pcls[li].reshape(-1))
        bce = -(cls_labels * torch.log(torch.clamp(p, min=1e-7))
                + (1 - cls_labels) * torch.log(torch.clamp(1 - p,
                                                           min=1e-7)))
        loss_cls = loss_cls + torch.where(valid > 0, bce,
                                          torch.zeros_like(bce)).sum() \
            / n_valid
    loss_cls = loss_cls / pcls.shape[0] * float(weights["rcnn_cls_weight"])
    tb["rcnn_loss_cls"] = loss_cls
    total = loss_reg + loss_cls
    tb["rcnn_loss"] = total
    return total, {k: v.detach() for k, v in tb.items()}


# --------------------------------------------------- the streaming path

def transform_boxes_to_current(boxes, pose_pre, pose_cur):
    """Boxes (..., R, C>=9) from pose_pre's frame into pose_cur's (poses
    (..., 4, 4), broadcast over the leading axes): centres and velocities
    through float64 poses, the heading by the poses' yaw difference, cast
    back at the end."""
    dt = boxes.dtype
    bx = boxes.double()
    pre, cur = pose_pre.double(), pose_cur.double()
    xyz1 = torch.cat([bx[..., :3], torch.ones_like(bx[..., :1])], dim=-1)
    world = xyz1 @ pre.transpose(-1, -2)
    world = torch.cat([world[..., :3], torch.ones_like(world[..., 3:])], -1)
    xyz = (world @ torch.linalg.inv(cur.transpose(-1, -2)))[..., :3]
    v3 = torch.cat([bx[..., 7:9], torch.zeros_like(bx[..., :1])], dim=-1)
    vg = v3 @ pre[..., :3, :3].transpose(-1, -2)
    vc = (vg @ torch.linalg.inv(cur[..., :3, :3].transpose(-1, -2)))[..., :2]
    dyaw = torch.atan2(pre[..., 1, 0], pre[..., 0, 0]) \
        - torch.atan2(cur[..., 1, 0], cur[..., 0, 0])
    out = torch.cat([xyz, bx[..., 3:6], bx[..., 6:7] + dyaw[..., None, None],
                     vc, bx[..., 9:]], dim=-1)
    return out.to(dt)


def init_mppnet_memory(rois11, pose, num_frames: int, num_proxy: int,
                       hidden: int):
    """The first frame's memory: every slot holds the current frame, the
    features zero (sample_idx gates them off). rois11 (B, R, 11); pose
    (B, 4, 4)."""
    b, r, c = rois11.shape
    return {"rois": rois11[:, None].expand(b, num_frames, r, c).clone(),
            "poses": pose[:, None].expand(b, num_frames, 4, 4).clone(),
            "feature": rois11.new_zeros(b, num_frames - 1, r, num_proxy,
                                        hidden)}


def mppnet_e2e_push_rois(memory, rois11, pose):
    """Before the head: the new frame's proposals and pose at slot 0."""
    return dict(memory,
                rois=torch.cat([rois11[:, None], memory["rois"][:, :-1]], 1),
                poses=torch.cat([pose[:, None], memory["poses"][:, :-1]], 1))


def mppnet_e2e_push_feature(memory, feat):
    """After the head: slot 0 of the features becomes the frame just
    processed. feat (B, R, G, D)."""
    return dict(memory, feature=torch.cat(
        [feat[:, None], memory["feature"][:, :-1]], 1))


class MPPNetHeadE2E(MPPNetHead):
    """Streaming MPPNet, inference only: one frame of points a step, the
    past frames' pooled features served from the memory bank. Batch keys
    ``memory_rois`` (B, F, R, 11) in each frame's own coordinates (slot 0
    current; columns 9 and 10 the score and label), ``poses`` (B, F, 4,
    4), ``memory_feature`` (B, F-1, R, G, D), ``sample_idx`` (B,) the
    frames seen so far; ``points`` / ``points_mask`` the current sweep
    only. Writes ``geometry_feature_memory`` (B, R, G, D) for the bank.
    MPPNetHead's modules, so an offline checkpoint loads into it."""

    @torch.no_grad()
    def forward(self, batch, generator=None):
        if self.training:
            raise RuntimeError("MPPNetHeadE2E is inference-only: train the "
                               "offline MPPNetHead")
        f, p_pts, g_pts = self.num_frames, self.p_pts, self.g_pts
        hidden, code = self.hidden, self.coder.code_size
        mem_rois, poses = batch["memory_rois"], batch["poses"]
        b, nf, r, _ = mem_rois.shape
        if nf != f:
            raise ValueError(f"memory_rois holds {nf} frames, the head {f}")
        proposals = transform_boxes_to_current(mem_rois[..., :9], poses,
                                               poses[:, :1])
        prop_valid = proposals[..., :6].abs().sum(-1) > 0
        traj, valid_len, assign = generate_trajectory(proposals, prop_valid)
        rois = traj[:, 0]
        scores0 = mem_rois[:, 0, :, 9]
        roi_labels = mem_rois[:, 0, :, 10].long()
        empty_mask = rois[..., :6].abs().sum(-1) <= 0

        pts = batch["points"]
        crop, crop_valid = crop_points_to_rois(pts, batch["points_mask"],
                                               rois[..., :7], p_pts)
        crop = crop[..., :self._feat_dim(pts)]
        t7 = traj[..., :7]
        anchor9 = box_anchor_points(t7).transpose(1, 2)       # (B,R,F,9,3)
        diag = torch.linalg.norm(traj[..., 3:6], dim=-1).transpose(1, 2)
        geo = self._geometry_in(crop, anchor9[:, :, 0], diag[:, :, 0])
        proxies = proxy_grid_points(t7.transpose(1, 2), self.grid)
        br = b * r
        cur = self._pool(proxies[:, :, 0].reshape(br, g_pts, 3),
                         crop[..., :3].reshape(br, p_pts, 3),
                         crop_valid.reshape(br, p_pts),
                         geo.reshape(br, p_pts, -1)).reshape(
                             b, r, g_pts, hidden)
        batch["geometry_feature_memory"] = cur
        sample_idx = batch["sample_idx"].long()
        bank = batch["memory_feature"]
        frames = [cur]
        for i in range(1, f):
            gathered = torch.gather(bank[:, i - 1], 1, assign[:, i, :, None,
                                                              None].expand(
                b, r, g_pts, hidden))
            usable = valid_len[:, i] & (sample_idx[:, None] >= i)
            frames.append(torch.where(usable[..., None, None], gathered,
                                      cur))
        geo_feat = torch.stack(frames, 2).reshape(b, r, f * g_pts, hidden)
        motion = self._motion(proxies.reshape(b, r, f * g_pts, 3),
                              anchor9[:, :, 0], diag[:, :, 0])
        feats = geo_feat + motion
        if bool(self.model_cfg.get("USE_TRAJ_EMPTY_MASK", False)):
            feats = torch.where(empty_mask[..., None, None],
                                torch.zeros_like(feats), feats)
        _, box_feat = self._box_branch(traj)
        point_cls, _, joint_reg = self._refine(
            feats.reshape(br, f * g_pts, hidden), box_feat, generator)
        rcnn_cls = point_cls[-1].reshape(b, r)
        rcnn_reg = joint_reg.reshape(b, r, code)
        batch = self._decode(batch, rois, rois[..., 7:9], rcnn_reg,
                             rcnn_cls, scores0, roi_labels)
        batch["roi_valid"] = prop_valid[:, 0] & ~empty_mask
        batch["mppnet_preds"] = {"rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg}
        return batch
