"""Alternative open-vocabulary proposers, the ablation baselines of the
extraction CLI's alt mode — port of findnpropagate_tpu/openvocab/
alt_proposers.py.

* `gt_proposals`: the recall upper bound, the ground truth as detections.
* `FrustumClusterProposer`, `FrustumDBSCAN`, `FrustumOV3DET`: cluster the
  in-frustum points of each cached 2D detection (DBSCAN) and place an
  anchor box, a min/max box or a PCA-yaw box on the clusters.
* `FrustumProposerBase` (registered as "FrustumProposer"): one HDBSCAN over
  every frustum's points and labels, then per cluster a line search along
  its principal direction scored by back-projected IoU, density, inliers
  and occlusion.
* `Clip2SceneProposer`: per-point semantic labels clustered per class.
* `ALT_PROPOSER_REGISTRY`, which also names FGR (openvocab/fgr.py).

Host numpy, as in the reference, and its proposers line for line.
The clustering is utils/clustering.py's, which gives scikit-learn's labels
without importing sklearn (the reference calls sklearn when it is
installed and otherwise falls back to a grid-hash connected-components
pass that is not DBSCAN). The anchors are the seeker's
(frustum_proposer.NUSCENES_ANCHORS), the box corners utils/geometry_np.py's.
"""

from __future__ import annotations

import numpy as np

from ..utils.clustering import dbscan, hdbscan
from ..utils.geometry_np import boxes_to_corners_3d
from .frustum_proposer import NUSCENES_ANCHORS


def gt_proposals(gt_boxes, max_label: int = 10):
    """(M, 8) padded gt -> (boxes (K, 7), scores, labels) — GTProposals."""
    labels = gt_boxes[:, -1].astype(np.int64)
    keep = (labels > 0) & (labels <= max_label)
    boxes = gt_boxes[keep, :7]
    labels = labels[keep]
    return boxes, np.ones(len(boxes), np.float32), labels


class FrustumClusterProposer:
    """Cluster-based frustum proposer (FrustumProposer /
    FrustumClusterProposer / FrustumDBSCAN semantics)."""

    def __init__(self, class_names, anchors=None, num_rot: int = 10,
                 eps: float = 0.8, min_samples: int = 5,
                 min_cam_iou: float = 0.1, iou_w: float = 0.9,
                 dns_w: float = 0.5, score_thr: float = 0.1,
                 topk: int = 1, max_dist: float = 60.0,
                 image_size=(900, 1600)):
        self.class_names = list(class_names)
        self.anchors = np.asarray(
            anchors if anchors is not None else NUSCENES_ANCHORS, np.float32)
        self.num_rot = num_rot
        self.eps = eps
        self.min_samples = min_samples
        self.min_cam_iou = min_cam_iou
        self.iou_w = iou_w
        self.dns_w = dns_w
        self.score_thr = score_thr
        self.topk = topk
        self.max_dist = max_dist
        self.image_size = image_size

    def _project(self, pts, l2i):
        hom = pts @ l2i[:3, :3].T + l2i[:3, 3]
        depth = hom[:, 2]
        uv = hom[:, :2] / np.clip(depth[:, None], 1e-5, None)
        return uv, depth

    def propose(self, points, det_boxes, det_labels, det_scores, det_cams,
                lidar2image):
        """points (P, 3+); cached dets (D, ...); lidar2image (NCAM, 4, 4).
        Returns (boxes (K, 7), scores, labels) numpy arrays."""
        h_img, w_img = self.image_size
        pts = points[:, :3]
        out_boxes, out_scores, out_labels = [], [], []
        for di in range(len(det_boxes)):
            if det_scores[di] < self.score_thr:
                continue
            cam = int(det_cams[di])
            l2i = lidar2image[cam]
            uv, depth = self._project(pts, l2i)
            x1, y1, x2, y2 = det_boxes[di]
            on = ((depth > 0) & (uv[:, 0] >= x1) & (uv[:, 0] < x2)
                  & (uv[:, 1] >= y1) & (uv[:, 1] < y2)
                  & (np.linalg.norm(pts, axis=1) < self.max_dist))
            box_pts = pts[on]
            if len(box_pts) < self.min_samples:
                continue
            cl = dbscan(box_pts, self.eps, self.min_samples)
            anchor = self.anchors[int(det_labels[di]) - 1]
            cands, scores = [], []
            for cid in range(cl.max() + 1):
                members = box_pts[cl == cid]
                ctr = members.mean(axis=0)
                for rot in np.linspace(0, np.pi, self.num_rot,
                                       endpoint=False):
                    cand = np.array([ctr[0], ctr[1], ctr[2],
                                     anchor[0], anchor[1], anchor[2], rot],
                                    np.float32)
                    # back-projected IoU
                    cor = boxes_to_corners_3d(cand[None])[0]
                    uvc, dc = self._project(cor, l2i)
                    uvc[:, 0] = np.clip(uvc[:, 0], 0, w_img)
                    uvc[:, 1] = np.clip(uvc[:, 1], 0, h_img)
                    px1, py1 = uvc.min(axis=0)
                    px2, py2 = uvc.max(axis=0)
                    ix = max(0.0, min(px2, x2) - max(px1, x1))
                    iy = max(0.0, min(py2, y2) - max(py1, y1))
                    inter = ix * iy
                    union = ((px2 - px1) * (py2 - py1)
                             + (x2 - x1) * (y2 - y1) - inter)
                    iou = inter / max(union, 1e-9)
                    if iou <= self.min_cam_iou:
                        continue
                    # density: members inside candidate
                    sh = members - cand[:3]
                    c_, s_ = np.cos(-rot), np.sin(-rot)
                    lx = sh[:, 0] * c_ - sh[:, 1] * s_
                    ly = sh[:, 0] * s_ + sh[:, 1] * c_
                    inside = ((np.abs(lx) <= anchor[0] / 2)
                              & (np.abs(ly) <= anchor[1] / 2)
                              & (np.abs(sh[:, 2]) <= anchor[2] / 2))
                    dens = inside.mean() if len(members) else 0.0
                    cands.append(cand)
                    scores.append(self.iou_w * iou + self.dns_w * dens)
            if not cands:
                continue
            order = np.argsort(-np.asarray(scores))[: self.topk]
            for oi in order:
                out_boxes.append(cands[oi])
                out_scores.append(float(det_scores[di]))
                out_labels.append(int(det_labels[di]))
        if not out_boxes:
            return (np.zeros((0, 7), np.float32), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        return (np.stack(out_boxes), np.asarray(out_scores, np.float32),
                np.asarray(out_labels, np.int64))


class FrustumDBSCAN:
    """FrustumDBSCAN (frustum_dbscan.py:38-351): cluster the in-frustum
    points of each cached 2D detection with DBSCAN and emit an
    AXIS-ALIGNED min/max bounding box per cluster (yaw 0) — no anchor
    priors, no scoring; the detection's label/score ride along. Options:
    `combine_clusters` collapses all non-noise points into one cluster
    (frustum_dbscan.py:304-308); `cluster_together` pools every frustum's
    points (with label/camera features) into ONE clustering and
    majority-votes each cluster's label (:219-266)."""

    def __init__(self, class_names, eps: float = 0.8, min_samples: int = 5,
                 min_cluster_size: int = 5, combine_clusters: bool = False,
                 cluster_together: bool = False, score_thr: float = 0.1,
                 max_dist: float = 60.0, image_size=(900, 1600)):
        self.class_names = list(class_names)
        self.eps = eps
        self.min_samples = min_samples
        self.min_cluster_size = min_cluster_size
        self.combine_clusters = combine_clusters
        self.cluster_together = cluster_together
        self.score_thr = score_thr
        self.max_dist = max_dist
        self.image_size = image_size

    def _project(self, pts, l2i):
        hom = pts @ l2i[:3, :3].T + l2i[:3, 3]
        depth = hom[:, 2]
        uv = hom[:, :2] / np.clip(depth[:, None], 1e-5, None)
        return uv, depth

    @staticmethod
    def _minmax_box(xyz):
        lo = xyz.min(axis=0)
        hi = xyz.max(axis=0)
        ctr = (lo + hi) / 2
        dim = hi - lo
        return np.array([ctr[0], ctr[1], ctr[2], dim[0], dim[1], dim[2],
                         0.0], np.float32)

    def propose(self, points, det_boxes, det_labels, det_scores, det_cams,
                lidar2image):
        pts = points[:, :3]
        frusts = []            # (xyz, label, score)
        for di in range(len(det_boxes)):
            if det_scores[di] < self.score_thr:
                continue
            cam = int(det_cams[di])
            uv, depth = self._project(pts, lidar2image[cam])
            x1, y1, x2, y2 = det_boxes[di]
            on = ((depth > 0) & (uv[:, 0] >= x1) & (uv[:, 0] < x2)
                  & (uv[:, 1] >= y1) & (uv[:, 1] < y2)
                  & (np.linalg.norm(pts, axis=1) < self.max_dist))
            if on.sum() == 0:
                continue
            frusts.append((pts[on], int(det_labels[di]),
                           float(det_scores[di])))

        out_boxes, out_scores, out_labels = [], [], []

        def emit(xyz, label, score):
            out_boxes.append(self._minmax_box(xyz))
            out_labels.append(label)
            out_scores.append(score)

        if self.cluster_together and frusts:
            # pooled clustering; per-cluster majority label (:245-252)
            X = np.concatenate([f[0] for f in frusts])
            lab = np.concatenate(
                [np.full(len(f[0]), f[1]) for f in frusts])
            sc = np.concatenate(
                [np.full(len(f[0]), f[2], np.float32) for f in frusts])
            cl = dbscan(X, self.eps, self.min_samples)
            for cid in range(cl.max() + 1):
                m = cl == cid
                if m.sum() < self.min_cluster_size:
                    continue
                vals, counts = np.unique(lab[m], return_counts=True)
                emit(X[m], int(vals[np.argmax(counts)]),
                     float(sc[m].mean()))
        else:
            for xyz, label, score in frusts:
                if len(xyz) <= max(2, self.min_samples):
                    continue
                cl = dbscan(xyz, self.eps, self.min_samples)
                if self.combine_clusters:
                    cl = np.where(cl >= 0, 0, -1)
                for cid in range(cl.max() + 1):
                    m = cl == cid
                    if m.sum() < self.min_cluster_size:
                        continue
                    emit(xyz[m], label, score)

        if not out_boxes:
            return (np.zeros((0, 7), np.float32),
                    np.zeros(0, np.float32), np.zeros(0, np.int64))
        return (np.stack(out_boxes), np.asarray(out_scores, np.float32),
                np.asarray(out_labels, np.int64))


def compute_pca_bbox(xyz):
    """PCA-yaw oriented bounding box (frustum_ov3ddet.py:34-68
    compute_bbox): yaw from the first 2D principal component, min/max
    extents in the de-rotated frame, center rotated back. Returns
    (cx, cy, cz, dx, dy, dz, yaw) with the reference's `-yaw` convention
    applied by CALLERS (they negate)."""
    xy = xyz[:, :2] - xyz[:, :2].mean(axis=0)
    cov = xy.T @ xy / max(len(xy), 1)
    _, vecs = np.linalg.eigh(cov)
    v = vecs[:, -1]                      # principal component
    yaw = float(np.arctan2(v[1], v[0]))
    c, s = np.cos(-yaw), np.sin(-yaw)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    local = xyz @ rot.T
    lo, hi = local.min(axis=0), local.max(axis=0)
    dims = hi - lo
    ctr_local = (lo + hi) / 2
    ctr = ctr_local @ np.array([[np.cos(yaw), -np.sin(yaw), 0],
                                [np.sin(yaw), np.cos(yaw), 0],
                                [0, 0, 1.0]]).T
    return (float(ctr[0]), float(ctr[1]), float(ctr[2]),
            float(dims[0]), float(dims[1]), float(dims[2]), yaw)


class FrustumOV3DET:
    """OV-3DET-style proposer (frustum_ov3ddet.py:70-188): per 2D
    detection, subsample the frustum points to <= 3000, DBSCAN(0.75, 20),
    drop only the NOISE points (all clusters kept together), and fit one
    PCA-yaw oriented min/max box; needs >= `min_points` frustum points."""

    def __init__(self, class_names, eps: float = 0.75,
                 min_samples: int = 20, min_points: int = 100,
                 subsample_to: int = 3000, score_thr: float = 0.1,
                 max_dist: float = 60.0, image_size=(900, 1600)):
        self.class_names = list(class_names)
        self.eps = eps
        self.min_samples = min_samples
        self.min_points = min_points
        self.subsample_to = subsample_to
        self.score_thr = score_thr
        self.max_dist = max_dist
        self.image_size = image_size

    def propose(self, points, det_boxes, det_labels, det_scores, det_cams,
                lidar2image):
        pts = points[:, :3]
        out_boxes, out_scores, out_labels = [], [], []
        for di in range(len(det_boxes)):
            if det_scores[di] < self.score_thr:
                continue
            l2i = lidar2image[int(det_cams[di])]
            hom = pts @ l2i[:3, :3].T + l2i[:3, 3]
            depth = hom[:, 2]
            uv = hom[:, :2] / np.clip(depth[:, None], 1e-5, None)
            x1, y1, x2, y2 = det_boxes[di]
            on = ((depth > 0) & (uv[:, 0] >= x1) & (uv[:, 0] < x2)
                  & (uv[:, 1] >= y1) & (uv[:, 1] < y2)
                  & (np.linalg.norm(pts, axis=1) < self.max_dist))
            fr = pts[on]
            step = max(1, len(fr) // self.subsample_to)
            fr = fr[::step]
            if len(fr) < self.min_points:
                continue
            cl = dbscan(fr, self.eps, self.min_samples)
            keep = cl >= 0
            if keep.sum() < 1:
                continue
            xc, yc, zc, l, w, h, yaw = compute_pca_bbox(fr[keep])
            out_boxes.append(
                np.array([xc, yc, zc, l, w, h, -yaw], np.float32))
            out_labels.append(int(det_labels[di]))
            out_scores.append(float(det_scores[di]))
        if not out_boxes:
            return (np.zeros((0, 7), np.float32),
                    np.zeros(0, np.float32), np.zeros(0, np.int64))
        return (np.stack(out_boxes), np.asarray(out_scores, np.float32),
                np.asarray(out_labels, np.int64))


def _hdbscan(feats, min_cluster_size=5, device=None):
    """HDBSCAN (sklearn's defaults; its spanning tree on `device`); fewer
    points than min_cluster_size are all one cluster (the reference's
    HDBSCANCluster, frustum_proposals.py:28-40)."""
    if len(feats) < min_cluster_size:
        return np.zeros(len(feats), np.int64)
    return hdbscan(feats, min_cluster_size, device=device)


class FrustumProposerBase:
    """The registered base `FrustumProposer`
    (frustum_proposals.py:383-1067): pooled clustering of all frustum
    points (feats = xyz + det label, HDBSCAN), then per cluster

      * background rejection by the smallest SVD singular value
        (< bg_thr -> flat sheet -> background, :860-866),
      * a proposal line along the singular-value-weighted principal
        direction `dirf`, spanning mean +- dirf * |anchor|/2 (:868-875),
      * num_mags centres on that line, plus +-min(anchor_xy)/2 offsets
        along the BEV-orthogonal of the line (create_box_proposals
        :676-705), x num_rot yaws in [-pi/2, pi/2],
      * multicam 2D-IoU rejection (max over the cluster's source
        frustums' cams, min_cam_iou; calc_iou :501-523),
      * score = iou_w*iou + inlier_w*softmax(-inlier)
        + dns_w*softmax(npts) + occl_w*softmax(-occl)  (:563),
      * topk, then a copy emitted per source frustum and a per-frustum
        re-rank keeping proposals with score >= the frustum mean, final
        score = the cluster's max camera score (:916-938).

    Host-side numpy like the other ablation proposers, but for the
    spanning tree of its HDBSCAN, which runs on `device` (CUDA unless
    another device is named): the pooled frustums of a nuScenes frame hold
    tens of thousands of points, one Prim's step each."""

    def __init__(self, class_names, anchors=None, num_rot: int = 10,
                 num_mags: int = 10, iou_w: float = 0.9, dns_w: float = 0.5,
                 occl_w: float = 0.1, inlier_w: float = 0.1,
                 min_cam_iou: float = 0.1, min_dist: float = 1.0,
                 max_dist: float = 60.0, score_thr: float = 0.1,
                 topk: int = 1, bg_thr: float = 0.5,
                 min_cluster_points: int = 10, nms_2d: float = 0.4,
                 image_size=(900, 1600), device=None):
        self.class_names = list(class_names)
        self.device = device      # of the HDBSCAN's spanning tree
        self.anchors = np.asarray(
            anchors if anchors is not None else NUSCENES_ANCHORS, np.float32)
        self.num_rot = num_rot
        self.num_mags = num_mags
        self.iou_w = iou_w
        self.dns_w = dns_w
        self.occl_w = occl_w
        self.inlier_w = inlier_w
        self.min_cam_iou = min_cam_iou
        self.min_dist = min_dist
        self.max_dist = max_dist
        self.score_thr = score_thr
        self.topk = topk
        self.bg_thr = bg_thr
        self.min_cluster_points = min_cluster_points
        self.nms_2d = nms_2d
        self.image_size = image_size

    def _project(self, pts, l2i):
        hom = pts @ l2i[:3, :3].T + l2i[:3, 3]
        depth = np.clip(hom[:, 2], 1e-5, 1e5)
        uv = hom[:, :2] / depth[:, None]
        return uv, hom[:, 2]

    @staticmethod
    def _softmax(x):
        e = np.exp(x - x.max())
        return e / e.sum()

    def _cam_iou(self, boxes7, cam_box, l2i):
        """Back-projected clamped-bbox IoU vs one 2D box (calc_iou)."""
        h_img, w_img = self.image_size
        cor = boxes_to_corners_3d(boxes7).reshape(-1, 3)
        uv, _ = self._project(cor, l2i)
        uv = uv.reshape(-1, 8, 2)
        uv[..., 0] = np.clip(uv[..., 0], 0, w_img)
        uv[..., 1] = np.clip(uv[..., 1], 0, h_img)
        p1 = uv.min(axis=1)
        p2 = uv.max(axis=1)
        x1, y1, x2, y2 = cam_box
        ix = np.maximum(
            0.0, np.minimum(p2[:, 0], x2) - np.maximum(p1[:, 0], x1))
        iy = np.maximum(
            0.0, np.minimum(p2[:, 1], y2) - np.maximum(p1[:, 1], y1))
        inter = ix * iy
        union = ((p2[:, 0] - p1[:, 0]) * (p2[:, 1] - p1[:, 1])
                 + (x2 - x1) * (y2 - y1) - inter)
        return inter / np.maximum(union, 1e-9)

    @staticmethod
    def _points_in_boxes_count(points, boxes7):
        """Points-per-box (assign each point to the first containing box,
        matching points_in_boxes_gpu semantics)."""
        counts = np.zeros(len(boxes7), np.int64)
        if not len(points):
            return counts
        assigned = np.zeros(len(points), bool)
        for i, b in enumerate(boxes7):
            sh = points - b[:3]
            c_, s_ = np.cos(-b[6]), np.sin(-b[6])
            lx = sh[:, 0] * c_ - sh[:, 1] * s_
            ly = sh[:, 0] * s_ + sh[:, 1] * c_
            inside = (~assigned & (np.abs(lx) <= b[3] / 2)
                      & (np.abs(ly) <= b[4] / 2)
                      & (np.abs(sh[:, 2]) <= b[5] / 2))
            counts[i] = inside.sum()
            assigned |= inside
        return counts

    def _occl_scores(self, anchor, boxes7, points, dirs, mags):
        """Occlusion evidence (calc_occl_scores :583-627): query points
        pulled phi=min(anchor)/2 closer ("empty") and pushed phi further
        ("occluded") along each point's view ray should NOT be in the box
        while the real points should."""
        phi = anchor.min() / 2.0
        empty = dirs * (mags - phi)
        occl = dirs * (mags + phi)
        n_real = self._points_in_boxes_count(points, boxes7)
        n_empty = self._points_in_boxes_count(empty, boxes7)
        n_occl = self._points_in_boxes_count(occl, boxes7)
        return (n_occl + n_empty - 2 * n_real) / (2.0 * max(len(points), 1))

    def _inlier_scores(self, anchor, boxes7, points):
        """Mean squared overshoot of |projection onto box axes| beyond the
        anchor half-dims (calc_inlier_scores :629-671)."""
        a = anchor / 2.0
        out = np.zeros(len(boxes7), np.float32)
        for i, b in enumerate(boxes7):
            ry = b[6]
            ax1 = np.array([np.cos(ry), np.sin(ry), 0.0])
            ax2 = np.array([np.cos(ry + np.pi / 2),
                            np.sin(ry + np.pi / 2), 0.0])
            ax3 = np.array([0.0, 0.0, 1.0])
            ctr = points - b[:3]
            d0 = np.maximum(np.abs(ctr @ ax1) - a[0], 0.0)
            d1 = np.maximum(np.abs(ctr @ ax2) - a[1], 0.0)
            d2 = np.maximum(np.abs(ctr @ ax3) - a[2], 0.0)
            out[i] = (d0 ** 2).mean() + (d1 ** 2).mean() + (d2 ** 2).mean()
        return out

    def _line_proposals(self, anchor, geo_min, geo_max):
        """(num_rot, num_mags*3, 7) grid (create_box_proposals)."""
        geo_vec = geo_max - geo_min
        geo_dir = geo_vec / max(np.linalg.norm(geo_vec), 1e-8)
        orthog = np.array([-geo_dir[1], geo_dir[0], geo_dir[2]])
        rs = np.linspace(0, 1, self.num_mags)
        centres = geo_min[None] + geo_vec[None] * rs[:, None]
        a1 = anchor[:2].min() / 2.0
        centres = np.concatenate(
            [centres + orthog * a1, centres, centres - orthog * a1])
        rots = np.linspace(-np.pi / 2, np.pi / 2, self.num_rot)
        boxes = np.zeros((self.num_rot, len(centres), 7), np.float32)
        boxes[:, :, 3:6] = anchor
        boxes[:, :, :3] = centres[None]
        boxes[:, :, 6] = rots[:, None]
        return boxes.reshape(-1, 7)

    def propose(self, points, det_boxes, det_labels, det_scores, det_cams,
                lidar2image):
        pts = points[:, :3]
        mags = np.linalg.norm(pts, axis=1)

        # frustum gathering (get_proposals :763-819)
        frust_pts, frust_labels, frust_cams, frust_boxes, frust_scores = \
            [], [], [], [], []
        for di in range(len(det_boxes)):
            if det_scores[di] < self.score_thr:
                continue
            label = int(det_labels[di])
            if not (1 <= label <= len(self.anchors)):
                continue
            cam = int(det_cams[di])
            uv, depth = self._project(pts, lidar2image[cam])
            x1, y1, x2, y2 = det_boxes[di]
            on = ((depth >= self.min_dist) & (depth <= self.max_dist)
                  & (uv[:, 0] >= x1) & (uv[:, 0] < x2)
                  & (uv[:, 1] >= y1) & (uv[:, 1] < y2))
            if not on.any():
                continue
            frust_pts.append(pts[on])
            frust_labels.append(label)
            frust_cams.append(cam)
            frust_boxes.append(np.asarray(det_boxes[di], np.float64))
            frust_scores.append(float(det_scores[di]))
        empty = (np.zeros((0, 7), np.float32), np.zeros(0, np.float32),
                 np.zeros(0, np.int64))
        if not frust_pts:
            return empty

        # pooled clustering over (xyz, label) feats (:822-832)
        all_pts = np.concatenate(frust_pts)
        all_idx = np.concatenate(
            [np.full(len(p), i) for i, p in enumerate(frust_pts)])
        all_lab = np.concatenate(
            [np.full(len(p), frust_labels[i])
             for i, p in enumerate(frust_pts)])
        feats = np.concatenate([all_pts, all_lab[:, None]], 1)
        cl = _hdbscan(feats, device=self.device)

        # per-cluster proposals + scoring, bucketed per source frustum
        per_frust = {i: [] for i in range(len(frust_pts))}
        for cid in range(cl.max() + 1):
            m = cl == cid
            cpts = all_pts[m]
            if len(cpts) < self.min_cluster_points:
                continue
            label = int(all_lab[m][0])
            anchor = self.anchors[label - 1]
            frust_set = sorted(set(all_idx[m].tolist()))
            mean = cpts.mean(axis=0)
            rel = cpts - mean
            _, S, Vh = np.linalg.svd(rel, full_matrices=False)
            if S.min() < self.bg_thr:
                continue  # flat sheet -> background (:860-866)
            dirf = (S[:, None] * Vh).sum(axis=0)
            dirf = dirf / max(np.linalg.norm(dirf), 1e-8)
            r = np.linalg.norm(anchor) / 2.0
            boxes7 = self._line_proposals(anchor, mean - dirf * r,
                                          mean + dirf * r)
            ious = np.max(np.stack([
                self._cam_iou(boxes7, frust_boxes[i],
                              lidar2image[frust_cams[i]])
                for i in frust_set]), axis=0)
            keep = ious >= self.min_cam_iou
            if not keep.any():
                continue
            boxes7, ious = boxes7[keep], ious[keep]
            cmags = np.linalg.norm(cpts, axis=1, keepdims=True)
            cdirs = cpts / np.maximum(cmags, 1e-8)
            occl = self._occl_scores(anchor, boxes7, cpts, cdirs, cmags)
            inl = self._inlier_scores(anchor, boxes7, cpts)
            dens = self._points_in_boxes_count(cpts, boxes7).astype(
                np.float32)
            score = (ious * self.iou_w
                     + self._softmax(-inl) * self.inlier_w
                     + self._softmax(dens) * self.dns_w
                     + self._softmax(-occl) * self.occl_w)
            order = np.argsort(-score)[: self.topk]
            cam_score = max(frust_scores[i] for i in frust_set)
            for oi in order:
                for fi in frust_set:
                    per_frust[fi].append(
                        (boxes7[oi], float(score[oi]), cam_score, label))

        # per-frustum re-rank: keep >= mean proposal score (:916-938)
        out_boxes, out_scores, out_labels = [], [], []
        for fi, props in per_frust.items():
            if not props:
                continue
            sc = np.asarray([p[1] for p in props])
            keep = sc >= sc.mean() if len(sc) > 1 else np.ones(1, bool)
            for k in np.flatnonzero(keep):
                out_boxes.append(props[k][0])
                out_scores.append(props[k][2])
                out_labels.append(props[k][3])
        if not out_boxes:
            return empty
        return (np.stack(out_boxes), np.asarray(out_scores, np.float32),
                np.asarray(out_labels, np.int64))


# CLIP2Scene semantic label space (clip2scene_proposals.py:22-39)
CLASSES_NUSCENES_SEG = (
    "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
)
BG_LABEL = 100


class Clip2SceneProposer:
    """CLIP2SceneProposer (clip2scene_proposals.py:40-152): per-POINT
    semantic labels (cached CLIP2Scene predictions, passed in directly
    instead of the reference's hard-coded .pth paths) are mapped into the
    detector class space, background dropped, foreground clustered per
    class with DBSCAN (or pooled over xyz+label when `cluster_together`),
    and each cluster emits one PCA-yaw oriented box with the majority
    label, score 1.0."""

    def __init__(self, class_names, eps: float = 0.25,
                 min_samples: int = 15, min_cluster_size: int = 10,
                 cluster_together: bool = False):
        self.class_names = list(class_names)
        self.eps = eps
        self.min_samples = min_samples
        self.min_cluster_size = min_cluster_size
        self.cluster_together = cluster_together
        # seg label (1-indexed) -> det label (1-indexed) or BG
        self.label_map = np.full(len(CLASSES_NUSCENES_SEG) + 1, BG_LABEL,
                                 np.int64)
        self.label_map[0] = BG_LABEL
        for k, seg in enumerate(CLASSES_NUSCENES_SEG):
            for v, det in enumerate(self.class_names):
                if seg == det:
                    self.label_map[k + 1] = v + 1

    def propose(self, points, point_seg_labels):
        """points (P, 3+); point_seg_labels (P,) CLIP2Scene 0..16."""
        pts = points[:, :3]
        lab = self.label_map[np.clip(point_seg_labels, 0,
                                     len(self.label_map) - 1)]
        fg = lab != BG_LABEL
        pts, lab = pts[fg], lab[fg]
        out_boxes, out_scores, out_labels = [], [], []

        def emit(xyz, members_lab):
            if len(xyz) < self.min_cluster_size:
                return
            counts = np.bincount(members_lab)
            xc, yc, zc, l, w, h, yaw = compute_pca_bbox(xyz)
            out_boxes.append(
                np.array([xc, yc, zc, l, w, h, -yaw], np.float32))
            out_labels.append(int(np.argmax(counts)))
            out_scores.append(1.0)

        if self.cluster_together and len(pts):
            X = np.concatenate([pts, lab[:, None].astype(np.float64)], 1)
            cl = dbscan(X, self.eps, self.min_samples)
            for cid in range(cl.max() + 1):
                m = cl == cid
                emit(pts[m], lab[m])
        else:
            for det_label in range(1, len(self.class_names) + 1):
                m = lab == det_label
                if m.sum() == 0:
                    continue
                cl = dbscan(pts[m], self.eps, self.min_samples)
                sub = pts[m]
                sl = lab[m]
                for cid in range(cl.max() + 1):
                    cm = cl == cid
                    emit(sub[cm], sl[cm])
        if not out_boxes:
            return (np.zeros((0, 7), np.float32),
                    np.zeros(0, np.float32), np.zeros(0, np.int64))
        return (np.stack(out_boxes), np.asarray(out_scores, np.float32),
                np.asarray(out_labels, np.int64))


# Registry of ablation proposers keyed by the reference's registered NAMEs
# (pcdet/models/dense_heads/__init__.py:38-67). CLIP2SceneCCProposer is the
# cluster_together=True configuration of the same class
# (clip2scene_cc_proposals.py differs only in the pooled clustering).
def _make_fgr(class_names, **kw):
    from .fgr import FGR

    return FGR(class_names, **kw)


ALT_PROPOSER_REGISTRY = {
    "FGR": _make_fgr,
    "FrustumProposer": FrustumProposerBase,
    "FrustumClusterProposer": FrustumClusterProposer,
    "FrustumDBSCAN": FrustumDBSCAN,
    "FrustumOV3DET": FrustumOV3DET,
    "CLIP2SceneProposer": Clip2SceneProposer,
    "CLIP2SceneCCProposer": lambda class_names, **kw: Clip2SceneProposer(
        class_names, cluster_together=True, **kw),
    "GTProposals": gt_proposals,
}
