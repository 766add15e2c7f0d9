"""Greedy Box Seeker + Greedy Box Oracle (FrustumProposerOG) — port of
findnpropagate_tpu/openvocab/frustum_proposer.py:40-536.

Per cached 2D detection: 2D NMS -> depth quantiles of the points inside
the 2D box -> the camera frustum's corners lifted to LiDAR -> anchor-set
proposals (per-class sizes x size scales x yaws x depth magnitudes along
the frustum axis) -> front-centring by a softmin over corner distances ->
the oracle score (back-projected 2D IoU, point density, centre-distance
rank, and the optional alignment, occlusion and ego terms) -> axis-aligned
NMS -> top-k boxes.

Design for the card: every step is a batched tensor operation over all
detections of the frame (their proposals broadcast as (D, N) tensors),
with no loop over detections or proposals.
  * Each camera's points are sorted by depth once: one stable sort of the
    key and one gather of the 7 carried columns. A detection's depth
    quantiles then come from the cumulative count of its on-box mask in
    that order: the r-th smallest on-box depth sits where the count first
    exceeds r, `searchsorted(count, r, right=True)`. A per-detection point
    mask (the SEG variant's, in raw point order) is carried into the same
    order by the sort's permutation, so both of the reference's paths are
    this one.
  * Every use of the point-in-proposal test is masked by the on-box mask,
    so it runs over each detection's on-box points only, packed into a
    padded buffer: exact, since the counts are sums of booleans. The
    detections go `det_chunk` at a time in order of their point counts, so
    each chunk's buffer is about as wide as its detections need; sizing
    them reads the counts from the device once per frame (a host sync).
  * The greedy NMS loops are batched over cameras and over detections
    (ops/nms.py); with topk = 1 the proposal NMS needs no loop at all.

Arithmetic that the CPU and a CUDA card round alike: 3x3 products written
out (openvocab/camera.py), sums over the 8 corners or 3 coordinates taken
left to right, the proposal templates and the cosines and sines of their
headings computed once on the host, and the softmin's exp taken in
float64 and rounded once to float32. What is left to differ is a rare
double rounding of that exp.

Index clamps: the reference's gathers clamp out-of-range indices; here
the class index `label - 1` is clamped to [0, classes - 1], the camera
index to [0, NCAM - 1] and the quantile positions to [0, P - 1]
explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.nms import _suppress, nms_normal_bev
from ..utils.geometry import (
    CORNER_TEMPLATE,
    boxes_to_corners_3d,
    points_in_rotated_boxes,
)
from .camera import (
    boxes_2d_iou,
    get_cam_frustum,
    lift,
    lift_matrix,
    nms_2d,
    norm3,
    project_to_camera,
    seq_sum,
)

# nuScenes per-class size anchors (frustum_proposals_v1.py:270-281)
NUSCENES_ANCHORS = np.array(
    [
        [4.63, 1.97, 1.74],
        [6.93, 2.51, 2.84],
        [6.37, 2.85, 3.19],
        [10.5, 2.94, 3.47],
        [12.29, 2.90, 3.87],
        [0.50, 2.53, 0.98],
        [2.11, 0.77, 1.47],
        [1.70, 0.60, 1.28],
        [0.73, 0.67, 1.77],
        [0.41, 0.41, 1.07],
    ],
    dtype=np.float32,
)

NEG_SCORE = -1e9
# point-proposal tests one step of `in_box_stats` may hold (128 MiB per
# float32 temporary)
PAIRS_PER_STEP = 1 << 25


class SeekerOutput(NamedTuple):
    boxes: torch.Tensor    # (D*topk, 7) proposals
    scores: torch.Tensor   # (D*topk,) detection score per kept proposal
    oracle: torch.Tensor   # (D*topk,) oracle score
    labels: torch.Tensor   # (D*topk,) int32 1-indexed class
    valid: torch.Tensor    # (D*topk,) bool


# ---------------------------------------------------------------- helpers
# shared with the KITTI variant (frustum_proposer_kitti.py)

def to_device(x, device, dtype=None):
    """x (numpy array, tensor or number) as a tensor on `device`. Host
    data goes to a CUDA card through pinned memory without blocking, so
    the copy does not wait for the stream."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    t = torch.as_tensor(x)
    if dtype is not None and t.device.type == "cpu":
        t = t.to(dtype)
    if t.device != device:
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
    return t if dtype is None else t.to(dtype)


def linspace01(num: int) -> np.ndarray:
    """`jnp.linspace(0.0, 1.0, num)` in float32, bit for bit: the step
    i * (1 / (num - 1)) in float32, then the end point."""
    if num <= 1:
        return np.zeros((num,), np.float32)
    step = np.arange(num - 1, dtype=np.float32) * (
        np.float32(1.0) / np.float32(num - 1))
    return np.concatenate([step, np.ones(1, np.float32)])


def base_boxes(anchors, size_min, size_max, ry_min, ry_max, num_sizes,
               num_rotations):
    """(num_class, R*S, 7) zero-centred proposal templates (numpy: float64
    steps, float32 boxes)."""
    anchors = np.asarray(anchors, np.float32)
    sizes = np.linspace(size_min, size_max, num_sizes)
    rots = np.linspace(ry_min, ry_max, num_rotations)
    n_cls = anchors.shape[0]
    base = np.zeros((n_cls, num_rotations, num_sizes, 7), np.float32)
    base[:, :, :, 3:6] = anchors[:, None, None, :]
    base[:, :, :, 6] = rots[None, :, None]
    base[:, :, :, 3:6] *= sizes[None, None, :, None]
    return base.reshape(n_cls, -1, 7)


def constants(seeker, device):
    """The seeker's templates on `device`, made once per device on the
    host (so every device sees the same bits): base boxes (C, RS, 7), their
    corners (C, RS, 8, 3), cos and sin of minus their headings (C, RS), the
    corner template, the depth magnitudes (M,) and the quantile levels
    (3,)."""
    key = str(device)
    if key not in seeker._consts:
        base = torch.from_numpy(seeker.base_boxes())
        c = {"base": base,
             "corners": boxes_to_corners_3d(base.reshape(-1, 7)).reshape(
                 base.shape[0], -1, 8, 3),
             "cos_neg": torch.cos(-base[..., 6]),
             "sin_neg": torch.sin(-base[..., 6]),
             "template": torch.from_numpy(CORNER_TEMPLATE),
             "mags": torch.from_numpy(linspace01(seeker.num_mags)),
             "qs": torch.tensor([seeker.lq, seeker.uq, seeker.cq],
                                dtype=torch.float32)}
        if hasattr(seeker, "pc_bev_pos"):
            c["bev"] = torch.from_numpy(seeker.pc_bev_pos())
        seeker._consts[key] = {k: v.to(device) for k, v in c.items()}
    return seeker._consts[key]


def sort_by_depth(key, cols):
    """key (C, P); cols (K, C, P) -> cols in ascending key order per row
    (stable), and the permutation (C, P)."""
    _, perm = torch.sort(key, dim=-1, stable=True)
    return torch.gather(cols, 2, perm.expand(cols.shape)), perm


def on_box_mask(u, v, m, boxes):
    """u, v, m (D, P), boxes (D, 4) xyxy -> (D, P): m and inside the box
    (right and bottom edges open)."""
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
    return m & (v < y2) & (v >= y1) & (u < x2) & (u >= x1)


def box_quantiles(cnt, depth, cam, qs):
    """Depth quantiles (torch.quantile, linear) of each detection's on-box
    points. cnt (D, P) int32: running count of the on-box mask in the
    camera's depth order; depth (C, P) ascending per camera; cam (D,);
    qs (Q,) float32. Returns (D, Q); 0 where a detection has no point."""
    n = cnt[:, -1]
    idx_f = qs[None, :] * torch.clamp(n - 1, min=0).to(torch.float32)[:, None]
    lo = torch.floor(idx_f).to(torch.int32)
    hi = torch.ceil(idx_f).to(torch.int32)
    frac = idx_f - lo.to(torch.float32)
    # number of positions whose count is <= r: the r-th set position
    pos = torch.searchsorted(cnt, torch.cat([lo, hi], dim=1).contiguous(),
                             right=True)
    pos = torch.clamp(pos, max=cnt.shape[1] - 1)
    vals = depth[cam[:, None], pos]
    q = qs.shape[0]
    lo_v, hi_v = vals[:, :q], vals[:, q:]
    out = lo_v * (1 - frac) + hi_v * frac
    return torch.where((n > 0)[:, None], out, torch.zeros_like(out))


def proposals(consts, cls, close, vec):
    """Proposal boxes (D, N, 7), corners (D, N, 8, 3) and cos / sin of
    minus their headings (D, N), N = M * R * S, magnitudes outermost:
    centres close + vec * mag along the frustum axis."""
    centers = close[:, None, :] + vec[:, None, :] * consts["mags"][None, :,
                                                                   None]
    bb = consts["base"][cls]                                   # (D, RS, 7)
    corners = consts["corners"][cls][:, None] + centers[:, :, None, None, :]
    d, m, rs = bb.shape[0], centers.shape[1], bb.shape[1]
    boxes = torch.cat([bb[:, None, :, :3] + centers[:, :, None, :],
                       bb[:, None, :, 3:].expand(d, m, rs, 4)], dim=-1)

    def per_prop(t):
        return t[:, None].expand(d, m, rs).reshape(d, m * rs)
    return (boxes.reshape(d, m * rs, 7), corners.reshape(d, m * rs, 8, 3),
            per_prop(consts["cos_neg"][cls]),
            per_prop(consts["sin_neg"][cls]))


def front_centre(boxes, corners):
    """Softmin over the corners' distances to the ego origin: the weighted
    front centre wfc (D, N, 3); boxes and corners moved by box - wfc."""
    x = -norm3(corners)                                        # (D, N, 8)
    e = torch.exp((x - x.amax(dim=-1, keepdim=True)).double()).float()
    rank = e / seq_sum(e, -1)[..., None]
    wfc = seq_sum(rank[..., None] * corners, -2)
    shift = boxes[..., :3] - wfc
    boxes = torch.cat([boxes[..., :3] + shift, boxes[..., 3:]], dim=-1)
    return boxes, corners + shift[:, :, None, :], wfc


def projected_iou(uv, det_boxes, image_size):
    """uv (D, N, 8, 2) projected corners, clamped to the image, their
    bounding box's IoU with each detection's 2D box -> (D, N)."""
    h_img, w_img = image_size
    u = torch.clamp(uv[..., 0], 0, w_img)
    v = torch.clamp(uv[..., 1], 0, h_img)
    proj = torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)],
                       dim=-1)
    return boxes_2d_iou(proj, det_boxes[:, None, :])[..., 0]


def dist_rank(d, valid):
    """1 - (d - min) / (max - min + 1e-8), min and max over `valid`."""
    d_min = torch.where(valid, d, torch.full_like(d, float("inf"))).amin(-1)
    d_max = torch.where(valid, d, torch.full_like(d, float("-inf"))).amax(-1)
    return 1 - (d - d_min[:, None]) / (d_max - d_min + 1e-8)[:, None]


def masked_max(x, valid):
    return torch.where(valid, x, torch.zeros_like(x)).amax(-1)


def in_box_stats(cnt, cols, cam, boxes, cos_neg, sin_neg, chunk,
                 occl_min=None, aln=False):
    """Per proposal (D, N) float32: the count of its detection's on-box
    points inside it; with `occl_min` (D, N) also the count of on-box
    points farther from the ego than that but not inside (`occl`); with
    `aln` the in-box points' principal direction against the heading.

    cnt (D, P) int32: running count of each detection's on-box mask in its
    camera's depth order; cols (3, C, P) the points' xyz in that order.
    The detections are taken in order of their on-box counts, each step's
    on-box points packed into a (chunk, width) buffer, width its largest
    count (`searchsorted` of the running count finds the k-th point). A
    step takes `chunk` detections, or more while its tests stay within
    PAIRS_PER_STEP. The counts are sums of booleans, so neither the
    packing nor the steps change them; the alignment's float sums run over
    one width in every step, so it does not depend on them either. Reads
    the detections' counts from the device once: a host sync."""
    d_n, n_prop = boxes.shape[:2]
    n = cnt[:, -1]
    n_sorted, order = torch.sort(n, descending=True, stable=True)
    widths = n_sorted.cpu().tolist()
    out = {"counts": torch.zeros(d_n, n_prop, device=cnt.device)}
    if occl_min is not None:
        out["occl"] = torch.zeros_like(out["counts"])
    if aln:
        out["aln"] = torch.zeros_like(out["counts"])
    s = 0
    while s < d_n and widths[s] > 0:
        width = widths[0] if aln else widths[s]
        step = max(int(chunk), PAIRS_PER_STEP // (n_prop * width), 1)
        dets = order[s:s + step]
        s += step
        ks = torch.arange(1, width + 1, dtype=torch.int32,
                          device=cnt.device).expand(dets.shape[0], width)
        pos = torch.clamp(torch.searchsorted(cnt[dets], ks.contiguous()),
                          max=cnt.shape[1] - 1)
        p = cols[:, cam[dets][:, None], pos].permute(1, 2, 0)  # (c, W, 3)
        kv = (ks <= n[dets][:, None])[:, None, :]
        inside = points_in_rotated_boxes(p, boxes[dets], cos_neg[dets],
                                         sin_neg[dets])        # (c, N, W)
        in_fr = inside & kv
        out["counts"][dets] = in_fr.sum(-1).to(torch.float32)
        if occl_min is not None:
            fail = kv & (norm3(p)[:, None, :] > occl_min[dets][..., None]) \
                & ~inside
            out["occl"][dets] = fail.sum(-1).to(torch.float32)
        if aln:
            out["aln"][dets] = _alignment(p, in_fr, boxes[dets])
    return out


def canonical_sign(v):
    """v (..., 3) times the sign of its largest-magnitude component (the
    first of equal ones). LAPACK leaves an eigenvector's sign open, and
    the alignment term depends on it: this fixes it, on every device."""
    big = torch.gather(v, -1, v.abs().argmax(-1, keepdim=True))
    return torch.where(big < 0, -v, v)


def _alignment(p, in_fr, boxes):
    """Second principal direction of each proposal's in-box points against
    its heading (0 where it holds 3 points or fewer)."""
    m = in_fr.to(torch.float32)                                # (c, N, Pm)
    n_in = m.sum(-1)
    xyz = p.unbind(-1)
    mean = [(m * x[:, None, :]).sum(-1) / torch.clamp(n_in, min=1.0)
            for x in xyz]
    diff = [(x[:, None, :] - mu[..., None]) * m for x, mu in zip(xyz, mean)]
    cov = torch.stack([torch.stack([(diff[i] * diff[j]).sum(-1)
                                    for j in range(3)], -1)
                       for i in range(3)], -2)                 # (c, N, 3, 3)
    _, vecs = torch.linalg.eigh(cov)                           # ascending
    v2 = canonical_sign(vecs[..., :, 1])
    v2 = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + 1e-8)
    a = v2[..., 0] * torch.cos(boxes[..., 6]) \
        + v2[..., 1] * torch.sin(boxes[..., 6])
    return torch.where(n_in > 3, a, torch.zeros_like(a))


def select(boxes, oracle, idx, ok):
    """Gather the NMS picks idx (D, K) (-1 padded): boxes (D, K, 7),
    oracle (D, K), valid (D, K)."""
    sel = torch.clamp(idx, min=0).long()
    return (torch.gather(boxes, 1, sel[..., None].expand(*sel.shape, 7)),
            torch.gather(oracle, 1, sel), ok & (idx >= 0))


# ------------------------------------------------------------------ seeker

@dataclass(frozen=True)
class FrustumProposerOG:
    """Config container and seeker. Defaults = the reference's defaults
    (frustum_proposals_v1.py:146-148 and the nuscenes_box_seeker cfg)."""

    class_names: tuple
    anchors: tuple = tuple(map(tuple, NUSCENES_ANCHORS.tolist()))
    lq: float = 0.336
    uq: float = 0.356
    cq: float = 0.46
    iou_w: float = 0.95
    dst_w: float = 0.226
    dns_w: float = 0.05
    # optional oracle terms (reference defaults 0)
    aln_w: float = 0.0
    occl_w: float = 0.0
    ego_w: float = 0.0
    mult: bool = False        # MULT: multiplicative score blend
    occl_mult: bool = False   # OCCL_MULT: dns * iou * occl
    min_cam_iou: float = 0.3
    size_min: float = 0.957
    size_max: float = 1.2
    ry_min: float = 0.0
    ry_max: float = float(np.pi)
    num_mags: int = 6
    num_sizes: int = 4
    num_rotations: int = 10
    max_dist: float = 50.0
    topk: int = 1
    nms_2d_thresh: float = 0.7
    nms_normal: float = 0.7
    # frustum BEV-mask NMS: active when 0 < nms_3d < 1 (1.0 disables it)
    nms_3d: float = 1.0
    bev_nms_grid: tuple = (180, 180)
    # detections whose point-in-proposal tests run at once (bounds the
    # (chunk, N, Pmax) memory; no result depends on it)
    det_chunk: int = 8
    score_thr: float = 0.1
    frustum_min: float = 2.0
    image_size: tuple = (900, 1600)
    point_cloud_range: tuple = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)

    def __post_init__(self):
        object.__setattr__(self, "_consts", {})

    @classmethod
    def from_config(cls, model_cfg, class_names):
        p = dict(model_cfg.get("PARAMS", {}))
        kw = {}
        remap = {"nms_2d": "nms_2d_thresh", "score_thr": "score_thr"}
        for k, v in p.items():
            key = remap.get(k, k)
            if key in cls.__dataclass_fields__:
                kw[key] = v
        return cls(class_names=tuple(class_names), **kw)

    # ---- static precomputes ----

    def pc_bev_pos(self):
        """(G, 2) BEV cell coordinates spanning the point cloud range."""
        gx, gy = self.bev_nms_grid
        pcr = self.point_cloud_range
        xs = np.linspace(pcr[0], pcr[3], gx)
        ys = np.linspace(pcr[1], pcr[4], gy)
        xx, yy = np.meshgrid(xs, ys, indexing="ij")
        return np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)

    def base_boxes(self):
        """(num_class, R*S, 7) proposal templates (zero-centred)."""
        return base_boxes(self.anchors, self.size_min, self.size_max,
                          self.ry_min, self.ry_max, self.num_sizes,
                          self.num_rotations)

    def frustum_bev_masks(self, frust_boxes):
        """(D, 8, 3) LiDAR frustum corners -> (D, G) BEV-cell membership."""
        bev = constants(self, frust_boxes.device)["bev"]           # (G, 2)
        bev_mags = norm3(bev)
        bev_norm = bev / (bev_mags[:, None] + 1e-9)
        fbev = (frust_boxes[:, 0::2] + frust_boxes[:, 1::2]) / 2   # (D,4,3)
        far_c = (fbev[:, 2, :2] + fbev[:, 3, :2]) / 2

        def unit(v):
            return v / (norm3(v)[..., None] + 1e-9)

        left_n, right_n = unit(fbev[:, 2, :2]), unit(fbev[:, 3, :2])
        center_n = unit(far_c)
        l2b = unit(bev_norm[None] - left_n[:, None])               # (D,G,2)
        r2b = unit(bev_norm[None] - right_n[:, None])
        cos_lr = seq_sum(l2b * r2b, -1)
        cos_c = seq_sum(center_n[:, None] * bev_norm[None], -1)
        mags = norm3(fbev)                                         # (D, 4)
        return ((cos_lr < 0) & (cos_c > 0)
                & (bev_mags[None] >= mags.amin(1)[:, None])
                & (bev_mags[None] < mags.amax(1)[:, None]))

    def frustum_bev_nms(self, masks, scores, labels, valid):
        """Greedy mask-IoU NMS within class, in score order -> (D,) keep."""
        m = masks.to(torch.float32)
        inter = m @ m.T
        area = m.sum(1)
        iou = inter / (area[:, None] + area[None, :] - inter + 1e-8)
        sup_pair = (iou > self.nms_3d) & (labels[:, None] == labels[None, :])
        s = torch.where(valid, scores, torch.full_like(scores,
                                                       float("-inf")))
        _, order = torch.sort(-s, stable=True)
        keep_sorted = _suppress(sup_pair[order][:, order], valid[order])
        return torch.zeros_like(valid).scatter(0, order, keep_sorted)

    # ---- the seeker program ----

    def propose(self, points, points_mask, det_boxes, det_labels, det_scores,
                det_cams, det_mask, lidar2image, camera2lidar, intrinsics,
                lidar_aug_matrix=None, det_point_mask=None, device=None):
        """Single sample.

        points (P, >=3); det_* (D, ...) padded 2D detections (labels
        1-indexed, cams 0..NCAM-1, boxes xyxy); matrices (NCAM, 4, 4);
        numpy arrays or tensors. `det_point_mask` (D, P) optionally
        restricts which points count per detection (the SEG variant's
        foreground filter). Runs on `device` (default CUDA). Returns a
        SeekerOutput with D * topk slots."""
        dev = resolve_device(device)
        f32 = torch.float32
        pts = to_device(points, dev, f32)[:, :3]
        points_mask = to_device(points_mask, dev, torch.bool)
        det_boxes = to_device(det_boxes, dev, f32)
        det_labels = to_device(det_labels, dev, torch.int32)
        det_scores = to_device(det_scores, dev, f32)
        det_mask = to_device(det_mask, dev, torch.bool)
        l2i = to_device(lidar2image, dev, f32)
        c2l = to_device(camera2lidar, dev, f32)
        intr = to_device(intrinsics, dev, f32)
        lam = None if lidar_aug_matrix is None else to_device(
            lidar_aug_matrix, dev, f32)
        ncam = l2i.shape[0]
        cam = torch.clamp(to_device(det_cams, dev, torch.long), 0, ncam - 1)
        consts = constants(self, dev)
        n_cls = consts["base"].shape[0]
        cls = torch.clamp(det_labels.long() - 1, 0, n_cls - 1)

        # per-camera projection of all points, once
        coords, on_img = project_to_camera(pts, l2i, lam, self.image_size)
        on_img = on_img & points_mask[None, :]

        # per-camera per-class 2D NMS, all cameras in one batched loop
        cams = torch.arange(ncam, device=dev)[:, None]
        m = det_mask & (cam == cams) & (det_scores >= self.score_thr)
        keep = (nms_2d(det_boxes, det_scores, det_labels,
                       self.nms_2d_thresh, valid=m) & m).any(0)

        # each camera's points in depth order (off-image points last)
        key = torch.where(on_img, coords[..., 2],
                          torch.full_like(coords[..., 2],
                                          torch.finfo(f32).max))
        cols = torch.stack([coords[..., 0], coords[..., 1], coords[..., 2],
                            pts[None, :, 0].expand_as(key),
                            pts[None, :, 1].expand_as(key),
                            pts[None, :, 2].expand_as(key),
                            on_img.to(f32)])                    # (7, C, P)
        cols, perm = sort_by_depth(key, cols)
        u_s, v_s, d_s = cols[0], cols[1], cols[2]

        on_box = on_box_mask(u_s[cam], v_s[cam], cols[6][cam] > 0,
                             det_boxes)
        if det_point_mask is not None:
            dpm = to_device(det_point_mask, dev, torch.bool)
            on_box = on_box & torch.gather(dpm, 1, perm[cam])
        cnt = torch.cumsum(on_box, dim=1, dtype=torch.int32)
        n_box_pts = cnt[:, -1]
        q = box_quantiles(cnt, d_s, cam, consts["qs"])
        fmin = torch.clamp(q[:, 0], min=self.frustum_min)
        fmax = torch.clamp(q[:, 1], max=self.max_dist)
        cz = q[:, 2]
        del on_box

        # the frustum and the 2D box centre lifted to LiDAR
        extra_rots = None if lam is None else lam[:3, :3]
        extra_trans = None if lam is None else lam[:3, 3]
        combine = lift_matrix(c2l[:, :3, :3], intr[:, :3, :3])[cam]
        x1, y1, x2, y2 = det_boxes.unbind(-1)
        img_pts = torch.cat([
            torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, cz], -1)[:, None],
            get_cam_frustum(torch.stack([x1, y1, fmin, x2, y2, fmax], -1),
                            consts["template"])],
            dim=1)                                             # (D, 9, 3)
        lifted = lift(img_pts, combine[:, None], c2l[cam, None, :3, 3],
                      extra_rots, extra_trans)
        centre_xyz, frust_box = lifted[:, 0], lifted[:, 1:]
        fbev = (frust_box[:, 0::2] + frust_box[:, 1::2]) / 2
        close = (fbev[:, 0] + fbev[:, 1]) / 2
        far = (fbev[:, 2] + fbev[:, 3]) / 2

        boxes3d, corners, cos_neg, sin_neg = proposals(consts, cls, close,
                                                       far - close)
        d_n, n_prop = boxes3d.shape[:2]
        boxes3d, corners, wfc = front_centre(boxes3d, corners)
        prop_valid = norm3(wfc) < self.max_dist

        # oracle: back-projected 2D IoU
        pc, _ = project_to_camera(corners.reshape(d_n, n_prop * 8, 3),
                                  l2i[cam][:, None], lam, self.image_size)
        ious = projected_iou(pc[:, 0, :, :2].reshape(d_n, n_prop, 8, 2),
                             det_boxes, self.image_size)
        dists_ranked = dist_rank(norm3(wfc - centre_xyz[:, None]), prop_valid)
        prop_valid = prop_valid & (ious > self.min_cam_iou)

        # density over the on-box points (compacted), and the options
        occl = self.occl_w > 0 or self.occl_mult
        st = in_box_stats(cnt, cols[3:6], cam, boxes3d, cos_neg, sin_neg,
                          self.det_chunk,
                          occl_min=norm3(corners).amin(-1) if occl else None,
                          aln=self.aln_w > 0)
        counts = st["counts"]
        soft_density = counts / (masked_max(counts, prop_valid)[:, None]
                                 + 1e-8)
        if self.mult:
            oracle = (soft_density * self.dns_w) * (ious * self.iou_w) \
                * (dists_ranked * self.dst_w)
        else:
            oracle = soft_density * self.dns_w + ious * self.iou_w \
                + dists_ranked * self.dst_w
        if self.aln_w > 0:
            oracle = oracle + st["aln"] * self.aln_w
        if occl:
            if self.occl_mult:
                oracle = soft_density * ious * st["occl"]
            else:
                occl_ranked = 1.0 - st["occl"] / (
                    masked_max(st["occl"], prop_valid)[:, None] + 1e-6)
                oracle = oracle + self.occl_w * occl_ranked
        if self.ego_w > 0:
            ego_d = norm3(boxes3d[..., :3])
            oracle = oracle + self.ego_w * ego_d / (
                masked_max(ego_d, prop_valid)[:, None] + 1e-8)
        oracle = torch.where(prop_valid, oracle,
                             torch.full_like(oracle, NEG_SCORE))

        # axis-aligned NMS + topk over every detection's proposals at once
        idx, _ = nms_normal_bev(boxes3d, oracle, self.nms_normal,
                                pre_maxsize=n_prop, post_maxsize=self.topk,
                                valid_mask=prop_valid)
        boxes_o, oracle_o, valid_o = select(
            boxes3d, oracle, idx, (keep & (n_box_pts > 0))[:, None])

        if 0.0 < self.nms_3d < 1.0:
            fk = self.frustum_bev_nms(self.frustum_bev_masks(frust_box),
                                      det_scores, det_labels,
                                      valid_o.any(1))
            valid_o = valid_o & fk[:, None]
        k = self.topk
        return SeekerOutput(
            boxes=boxes_o.reshape(d_n * k, 7),
            scores=det_scores[:, None].expand(d_n, k).reshape(-1),
            oracle=oracle_o.reshape(d_n * k),
            labels=det_labels[:, None].expand(d_n, k).reshape(-1),
            valid=valid_o.reshape(d_n * k))

    def propose_batch(self, batch, device=None):
        """Batched entry: padded per-sample arrays in `batch`: points
        (B, P, 3+), points_mask, det_boxes (B, D, 4), det_labels,
        det_scores, det_cams, det_mask, lidar2image (B, NCAM, 4, 4),
        camera2lidar, camera_intrinsics, optional lidar_aug_matrix
        (B, 4, 4); without it each sample's augmentation is the identity
        (inverted and applied, as the reference does). Returns a
        SeekerOutput with a leading batch axis."""
        lam = batch.get("lidar_aug_matrix")
        b = len(batch["points"])
        outs = [self.propose(
            batch["points"][i], batch["points_mask"][i],
            batch["det_boxes"][i], batch["det_labels"][i],
            batch["det_scores"][i], batch["det_cams"][i],
            batch["det_mask"][i], batch["lidar2image"][i],
            batch["camera2lidar"][i], batch["camera_intrinsics"][i],
            lidar_aug_matrix=np.eye(4, dtype=np.float32) if lam is None
            else lam[i], device=device) for i in range(b)]
        return SeekerOutput(*(torch.stack(f) for f in zip(*outs)))
