"""FGR — the Frustum-aware Geometric Reasoning proposer, an ablation
baseline of the extraction CLI's alt mode — port of findnpropagate_tpu/
openvocab/fgr.py.

From a 2D box and the LiDAR points alone:
  1. RANSAC ground removal (`calculate_ground`): 3-point plane fits over
     the points below the sensor, near-vertical normals kept, 5 rounds;
  2. per 2D detection, near to far by median depth, multi-threshold
     region growing (`region_grow`) seeded at the in-frustum points off
     the ground, the largest grown cluster winning and its points taken
     from later objects;
  3. the key-vertex rectangle (`min_shrink_rect`, `find_key_vertex`,
     `delete_extremal`): a BEV yaw sweep scored by the points inside a
     shrunk interior, extremal points deleted until the key vertex
     settles;
  4. the frustum intersection: the two edges from the key vertex extended
     to the frustum's side rays, with the anchor aspect-ratio fallback when
     an intersection is degenerate, and the height from the frustum's top
     and bottom planes (or the ground plane for a truncated box).

Host numpy, as in the reference, and its drawing order: one
`np.random.RandomState(seed)` per FGR object, consumed by the RANSAC in
the same order. Like the reference, the frustum rays start at the camera
centre and are lifted at unit depth, and the BEV geometry lives in the
permuted (y, z, x) LiDAR frame (axis 1 up).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

# check_anchor_fitting defaults (fgr_utils.py:559-563): KITTI-median car
# height/width and height/length ratios.
HEIGHT_WIDTH_RATE = 0.9305644265920366
HEIGHT_LENGTH_RATE = 0.3969212090597959


def fit_plane(points):
    """Plane a.x = 1 through >=3 points (fgr_utils.py:732-736)."""
    if points.shape[0] == points.shape[1]:
        return np.linalg.solve(points, np.ones(points.shape[0]))
    return np.linalg.lstsq(points, np.ones(points.shape[0]), rcond=None)[0]


def _collinear(three):
    a = np.linalg.norm(three[0] - three[1])
    b = np.linalg.norm(three[1] - three[2])
    c = np.linalg.norm(three[2] - three[0])
    p = (a + b + c) / 2
    area2 = max(p * (p - a) * (p - b) * (p - c), 0.0)
    return np.sqrt(area2) < 1e-2


def calculate_ground(pc, thresh=0.15, rng=None, rounds=5, iters=100):
    """RANSAC ground mask in the permuted frame (axis 1 = up).
    Returns (non_ground_mask float 0/1, last plane's 3 sample points)."""
    rng = rng or np.random.RandomState(0)
    cloud = pc[pc[:, 1] < 0.0]
    mask_all = np.ones(len(pc))
    final_sample = None
    if len(cloud) < 3:
        return mask_all, final_sample
    for _ in range(rounds):
        best_len, mask_ground = 0, None
        for _ in range(min(len(cloud), iters)):
            idx = rng.choice(len(cloud), size=3, replace=False)
            sample = cloud[idx]
            if _collinear(sample):
                continue
            try:
                plane = fit_plane(sample)
            except np.linalg.LinAlgError:
                continue
            norm = np.linalg.norm(plane)
            if norm < 1e-9:
                continue
            diff = np.abs(pc @ plane - 1.0) / norm
            inlier = diff < thresh
            n = inlier.sum()
            if n > best_len and abs((plane / norm) @ [0.0, 1.0, 0.0]) > 0.9:
                best_len, mask_ground = n, inlier
                final_sample = sample
        if mask_ground is not None:
            mask_all *= 1 - mask_ground
    return mask_all, final_sample


def _neighbours(pc, thresh):
    """CSR lists (indptr, indices) of the pairs closer than `thresh`, by
    the reference's distance (np.linalg.norm of the difference in pc's
    dtype): the tree proposes pairs within a slightly larger radius and
    the exact test decides."""
    n = len(pc)
    pairs = cKDTree(pc).query_pairs(thresh * (1 + 1e-4),
                                    output_type="ndarray")
    d = np.linalg.norm(pc[pairs[:, 1]] - pc[pairs[:, 0]], axis=-1)
    pairs = pairs[d < thresh]
    a = np.concatenate([pairs[:, 0], pairs[:, 1]])
    b = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(a, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(a, minlength=n), out=indptr[1:])
    return indptr, b[order]


def region_grow(pc, mask_search, mask_origin, thresh, ratio=0.8):
    """Frontier BFS region growing (region_grow_my_version semantics):
    grow clusters within `mask_search` from seeds in `mask_origin`, in
    index order; a cluster whose in-origin fraction drops below `ratio`
    after an expansion is rejected (its points so far are no longer
    seeds); the largest accepted cluster wins, the first among equals. The
    reference grows one point per queue pop; this expands whole frontiers
    per step (same transitive closure, same reject rule checked per
    expansion) over the neighbour lists of the search points."""
    search_idx = np.flatnonzero(mask_search)
    pc_search = pc[search_idx]
    origin = mask_origin[search_idx].astype(bool)
    indptr, indices = _neighbours(pc_search, thresh)
    degree = np.diff(indptr)
    seeded = np.zeros(len(pc_search), bool)  # grown from an earlier seed
    stamp = np.full(len(pc_search), -1)      # in the cluster of seed `stamp`
    best_len, best = 0, None
    for start in np.flatnonzero(origin):
        if seeded[start]:
            continue
        seeded[start] = True
        if degree[start] == 0:      # a lone seed: itself, all in origin
            if best_len == 0:
                best_len, best = 1, np.array([start])
            continue
        stamp[start] = start
        members = [np.array([start])]
        n_in, n_origin = 1, 1
        ok = True
        while len(members[-1]):
            cand = np.concatenate([indices[indptr[f]:indptr[f + 1]]
                                   for f in members[-1]])
            new = np.unique(cand[stamp[cand] != start])
            stamp[new] = start
            members.append(new)
            n_in += len(new)
            n_origin += int(origin[new].sum())
            if ratio is not None and n_origin / n_in < ratio:
                ok = False
                break
        grown = np.concatenate(members)
        seeded[grown] = True
        if ok and n_in > best_len:
            best_len, best = n_in, grown
    best_mask = np.zeros(len(pc))
    if best is not None:
        best_mask[search_idx[best]] = 1
    if ratio is not None:
        return best_mask * mask_origin
    return best_mask


def min_shrink_rect(bev, shrink=0.025):
    """BEV yaw sweep minimizing the shrunk-interior point fraction
    (Find_2d_box step 1, fgr.py:473-527). Returns (corners (4,2)
    counter-clockwise from left-bottom, angle, rotated points)."""
    angles = np.arange(0, 90.5 * np.pi / 180, 0.5 * np.pi / 180)
    cs, sn = np.cos(angles), np.sin(angles)
    # rotate: temp[a] = bev @ R(angle_a)   (A, N, 2)
    rx = bev[:, 0][None] * cs[:, None] + bev[:, 1][None] * sn[:, None]
    ry = -bev[:, 0][None] * sn[:, None] + bev[:, 1][None] * cs[:, None]
    lo_x, hi_x = rx.min(1), rx.max(1)
    lo_y, hi_y = ry.min(1), ry.max(1)
    tx1 = lo_x + shrink * (hi_x - lo_x)
    tx2 = hi_x - shrink * (hi_x - lo_x)
    ty1 = lo_y + shrink * (hi_y - lo_y)
    ty2 = hi_y - shrink * (hi_y - lo_y)
    inside = ((rx >= tx1[:, None]) & (rx <= tx2[:, None])
              & (ry >= ty1[:, None]) & (ry <= ty2[:, None]))
    frac = inside.mean(axis=1)
    a = int(np.argmin(frac))
    angle = angles[a]
    box = np.array([[lo_x[a], lo_y[a]], [lo_x[a], hi_y[a]],
                    [hi_x[a], hi_y[a]], [hi_x[a], lo_y[a]]])
    rot_back = np.array([[np.cos(angle), np.sin(angle)],
                         [-np.sin(angle), np.cos(angle)]])
    box = box @ rot_back
    final = np.stack([rx[a], ry[a]], axis=1)
    return box.astype(np.float64), angle, final


def find_key_vertex(bev, box):
    """Corner on the denser side of each diagonal
    (find_key_vertex_by_pc_number, fgr_utils.py:503-557)."""
    def side(pts, p, q):
        return (pts[:, 0] * (p[1] - q[1]) - pts[:, 1] * (p[0] - q[0])
                + (p[0] * q[1] - p[1] * q[0]) > 0)

    idx1 = 0 if side(box[0:1], box[1], box[3])[0] else 2
    n1 = side(bev, box[1], box[3]).sum()
    if n1 < len(bev) / 2:
        n1 = len(bev) - n1
        idx1 = (idx1 + 2) % 4
    idx2 = 1 if side(box[1:2], box[0], box[2])[0] else 3
    n2 = side(bev, box[0], box[2]).sum()
    if n2 < len(bev) / 2:
        n2 = len(bev) - n2
        idx2 = (idx2 + 2) % 4
    return idx1, idx2, box[idx1], box[idx2], n1, n2


def delete_extremal(final, key_index, bev, times=2):
    """Drop `times` extremal points on the key-vertex side
    (delete_noisy_point_cloud, fgr_utils.py:468-501)."""
    for cond, axis, use_max in (
            (key_index in (2, 3), 0, True), (key_index in (0, 1), 0, False),
            (key_index in (1, 2), 1, True), (key_index in (0, 3), 1, False)):
        if not cond:
            continue
        for _ in range(times):
            if len(final) == 0:
                break
            i = int(np.argmax(final[:, axis]) if use_max
                    else np.argmin(final[:, axis]))
            bev = np.delete(bev, i, axis=0)
            final = np.delete(final, i, axis=0)
    return bev, final


def _ray_intersect(p0, d0, p1, d1):
    """Intersection of p0+t*d0 and p1+s*d1 in 2D; None if parallel."""
    A = np.array([[d0[0], -d1[0]], [d0[1], -d1[1]]])
    if abs(np.linalg.det(A)) < 1e-9:
        return None
    t, _ = np.linalg.solve(A, p1 - p0)
    return p0 + t * d0


class FGR:
    """Geometric frustum proposer. `propose` works per frame with the
    cached 2D detections and per-camera lidar2image matrices (any number
    of cameras; KITTI uses one)."""

    def __init__(self, class_names, thresh_ransac: float = 0.15,
                 thresh_seg_max: int = 5, region_growth_ratio: float = 0.8,
                 rect_shrink: float = 0.025, cut_rate_max: float = 0.025,
                 cut_rate_min: float = 0.001, cut_rate_max2: float = 0.02,
                 key_vertex_move_thresh: float = 0.01,
                 min_points_after_delete: int = 10,
                 delete_times_every_epoch: int = 2,
                 anchor_fit_degree_thresh: float = 10.0,
                 length_width_boundary: float = 2.2,
                 final_point_flip_thresh: float = -0.1,
                 score_thr: float = 0.1, nms_2d: float = 0.4,
                 max_region_points: int = 4000, min_region_points: int = 30,
                 image_size=(900, 1600), seed: int = 0):
        self.class_names = list(class_names)
        self.thresh_ransac = thresh_ransac
        self.thresh_seg_max = thresh_seg_max
        self.ratio = region_growth_ratio
        self.rect_shrink = rect_shrink
        self.cut_rate_max = cut_rate_max
        self.cut_rate_min = cut_rate_min
        self.cut_rate_max2 = cut_rate_max2
        self.key_vertex_move_thresh = key_vertex_move_thresh
        self.min_points_after_delete = min_points_after_delete
        self.delete_times = delete_times_every_epoch
        self.anchor_fit_degree_thresh = anchor_fit_degree_thresh
        self.length_width_boundary = length_width_boundary
        self.final_point_flip_thresh = final_point_flip_thresh
        self.score_thr = score_thr
        self.nms_2d = nms_2d
        self.max_region_points = max_region_points
        self.min_region_points = min_region_points
        self.image_size = image_size
        self.rng = np.random.RandomState(seed)

    # --- camera helpers -------------------------------------------------
    @staticmethod
    def _project(pts, l2i):
        hom = pts @ l2i[:3, :3].T + l2i[:3, 3]
        depth = hom[:, 2]
        uv = hom[:, :2] / np.clip(depth[:, None], 1e-5, None)
        return uv, depth

    @staticmethod
    def _lift(uv_depth, l2i):
        """Pixels (u, v, depth) -> lidar xyz via inv(lidar2image)."""
        inv = np.linalg.inv(l2i)
        u, v, d = uv_depth[:, 0], uv_depth[:, 1], uv_depth[:, 2]
        hom = np.stack([u * d, v * d, d, np.ones_like(d)], 1)
        out = hom @ inv.T
        return out[:, :3]

    # --- main geometric fit ----------------------------------------------
    def _fit_box(self, key_pts, box2d, l2i, truncated, ground_sample):
        """Find_2d_box equivalent. `key_pts` in the permuted (y, z, x)
        frame. Returns (key vertex, loc1, loc2, loc3, y_max, y_min) BEV
        corners or None."""
        if len(key_pts) < 10:
            return None
        bev = key_pts[:, [0, 2]].copy()  # (y_lidar, x_lidar) BEV

        # frustum boundary rays (camera centre + pixel-column directions)
        x1, y1, x2, y2 = [float(v) for v in box2d]
        vc = (y1 + y2) / 2.0
        cam_pos = self._lift(np.array([[0.0, 0.0, 1e-6]]), l2i)[0]
        lifted = self._lift(
            np.array([[x1, vc, 10.0], [x2, vc, 10.0],
                      [x1, y1, 10.0], [x2, y1, 10.0],
                      [x1, y2, 10.0], [x2, y2, 10.0]]), l2i)
        cam_bev = cam_pos[[1, 0]]
        left_dir = lifted[0][[1, 0]] - cam_bev
        right_dir = lifted[1][[1, 0]] - cam_bev
        mat_lr = np.stack([left_dir, right_dir], axis=1)
        if abs(np.linalg.det(mat_lr)) < 1e-9:
            return None

        # iterative min-shrink rect + noise deletion (fgr.py:473-567)
        cut = max(int(len(bev) * self.cut_rate_max), 1)
        second_phase = False
        key_point = np.array([0.0, 0.0])
        while True:
            box, angle, final = min_shrink_rect(bev, self.rect_shrink)
            i1, i2, p1, p2, n1, n2 = find_key_vertex(bev, box)
            cur_point, cur_idx = (p2, i2) if n1 < n2 else (p1, i1)
            if cut == 0 and ((cur_point - key_point) ** 2).sum() \
                    < self.key_vertex_move_thresh:
                break
            if cut == 0:
                key_point = cur_point
                if second_phase:
                    break
                second_phase = True
                cut = max(int(len(bev) * self.cut_rate_max2), 1)
            else:
                cut -= 1
                if len(bev) < self.min_points_after_delete:
                    return None
                bev, final = delete_extremal(final, cur_idx, bev,
                                             self.delete_times)
        i1, i2, p1, p2, n1, n2 = find_key_vertex(bev, box)
        fp, fi = (p2, i2) if n1 < n2 else (p1, i1)

        # height from frustum top/bottom planes at the key vertex
        # (Calculate_Height): planes through the camera centre and the
        # lifted top/bottom edge points; evaluate at BEV point fp.
        def plane_height(edge_pts):
            rel = edge_pts - cam_pos  # two rays (lidar frame)
            # plane normal (lidar): cross of the two edge rays
            n = np.cross(rel[0], rel[1])
            if abs(n[2]) < 1e-9:
                return None
            # plane: n . (p - cam_pos) = 0; fp is (y, x) BEV
            p_xy = np.array([fp[1], fp[0]])  # lidar (x, y)
            z = cam_pos[2] - (n[0] * (p_xy[0] - cam_pos[0])
                              + n[1] * (p_xy[1] - cam_pos[1])) / n[2]
            return z

        if not truncated:
            top = plane_height(lifted[2:4])
            bot = plane_height(lifted[4:6])
            if top is None or bot is None:
                return None
            y_min, y_max = min(top, bot), max(top, bot)
        else:
            y_min = key_pts[:, 1].min()
            y_max = key_pts[:, 1].max()
            if ground_sample is not None:
                plane = fit_plane(ground_sample)
                eps = 1e-8
                sign = np.sign(np.sign(plane[1]) + 0.5)
                y_gr = -(plane[0] * fp[0] + plane[2] * fp[1] - 1) \
                    / (plane[1] + eps * sign)
                if np.isfinite(y_gr):
                    y_min = min(y_min, y_gr)

        # frustum-side intersections from the key vertex (fgr.py:648-685)
        flip_w = np.linalg.solve(mat_lr, fp - cam_bev)
        if truncated or (flip_w < self.final_point_flip_thresh).any():
            loc1 = box[fi - 1].copy()
            loc2 = box[(fi + 1) % 4].copy()
        else:
            loc1, ang1 = self._edge_to_frustum(
                box, fi, -1, fp, cam_bev, left_dir, right_dir)
            loc2, ang2 = self._edge_to_frustum(
                box, fi, +1, fp, cam_bev, right_dir, left_dir)
            if loc1 is None or loc2 is None:
                return None
            loc1, loc2 = self._anchor_fallback(
                box, fi, fp, loc1, loc2, ang1, ang2, y_max, y_min)
        loc3 = loc1 - fp + loc2

        # key-vertex sanity: must be among the 2 nearest corners in depth
        nearer = sum(1 for i in range(4)
                     if i != fi and box[i, 1] < box[fi, 1])
        if nearer >= 2:
            return None
        return fp, loc1, loc2, loc3, y_max, y_min

    def _edge_to_frustum(self, box, fi, step, fp, cam_bev, prim, alt):
        """Extend the bbox edge fp->box[fi+step] to the frustum boundary
        (Find_Intersection_Point). The key vertex usually LIES on one
        boundary ray (near corners define the 2D box sides), which makes
        that ray's intersection degenerate at fp — so intersect with both
        rays, keep forward hits, and take the farther one; near-parallel
        blow-ups are handled by the small-angle anchor fallback."""
        corner = box[(fi + step) % 4]
        edge = corner - fp
        best = None
        for ray in (prim, alt):
            hit = _ray_intersect(fp, edge, cam_bev, ray)
            if hit is None:
                continue
            v = hit - fp
            if v @ (corner - fp) <= 0:
                continue
            d = np.linalg.norm(v)
            sin = abs(ray[0] * v[1] - ray[1] * v[0]) / max(
                d * np.linalg.norm(ray), 1e-9)
            ang = np.arcsin(min(sin, 1.0))
            if best is None or d > best[2]:
                best = (hit, ang, d)
        if best is None:
            return corner.copy(), np.pi / 2
        return best[0], best[1]

    def _anchor_fallback(self, box, fi, fp, loc1, loc2, ang1, ang2,
                         y_max, y_min):
        """check_anchor_fitting: when an intersection is degenerate (tiny
        angle to the frustum ray), rescale that edge from the box height
        and the KITTI median aspect ratios."""
        h = abs(y_max - y_min)

        def rescale(loc, other):
            d_other = np.linalg.norm(other - fp)
            rate = HEIGHT_WIDTH_RATE if d_other > \
                self.length_width_boundary else HEIGHT_LENGTH_RATE
            d = np.linalg.norm(loc - fp)
            if d < 1e-9:
                return loc
            return fp + (loc - fp) * (h / rate) / d

        deg1 = ang1 * 180 / np.pi
        deg2 = ang2 * 180 / np.pi
        if deg1 < self.anchor_fit_degree_thresh:
            loc1 = rescale(loc1, loc2)
        elif deg2 < self.anchor_fit_degree_thresh:
            loc2 = rescale(loc2, loc1)
        return loc1, loc2

    # --- per frame ---------------------------------------------------------
    def propose(self, points, det_boxes, det_labels, det_scores, det_cams,
                lidar2image):
        pts = np.asarray(points)[:, :3]
        empty = (np.zeros((0, 7), np.float32), np.zeros(0, np.float32),
                 np.zeros(0, np.int64))
        out_boxes, out_scores, out_labels = [], [], []
        h_img, w_img = self.image_size
        for cam in sorted(set(int(c) for c in det_cams)):
            sel = [i for i in range(len(det_boxes))
                   if int(det_cams[i]) == cam
                   and det_scores[i] >= self.score_thr]
            if not sel:
                continue
            l2i = np.asarray(lidar2image[cam], np.float64)
            uv, depth = self._project(pts, l2i)
            on_img = (depth > 1e-3) & (uv[:, 0] >= 0) & (uv[:, 0] < w_img) \
                & (uv[:, 1] >= 0) & (uv[:, 1] < h_img)
            cam_pts = pts[on_img]
            cam_uv = uv[on_img]
            if len(cam_pts) < 10:
                continue
            perm = cam_pts[:, [1, 2, 0]]  # (y, z, x): axis 1 = up

            non_ground, ground_sample = calculate_ground(
                perm, self.thresh_ransac, self.rng)

            # near-to-far object order by median lidar depth
            order, obj_filters = [], {}
            for i in sel:
                x1, y1, x2, y2 = det_boxes[i]
                on = ((cam_uv[:, 0] >= x1) & (cam_uv[:, 0] < x2)
                      & (cam_uv[:, 1] >= y1) & (cam_uv[:, 1] < y2))
                if on.sum() == 0:
                    continue
                obj_filters[i] = on
                order.append((np.median(cam_pts[on][:, 0]), i))
            order.sort()
            any_filter = np.zeros(len(cam_pts), bool)
            for _, i in order:
                any_filter |= obj_filters[i]

            mask_object = np.ones(len(cam_pts))
            for _, i in order:
                obj = obj_filters[i].astype(float)
                mask_search = non_ground * any_filter * mask_object
                if mask_search.sum() == 0:
                    continue
                # multi-threshold region growth; largest cluster wins
                best_mask, best_n = None, 0
                prev, changes = None, 0
                for j in range(self.thresh_seg_max):
                    thr = (j + 1) * 0.1
                    m0 = non_ground * obj * mask_object
                    seg = region_grow(perm, mask_search, m0, thr,
                                      self.ratio)
                    if seg.sum() == 0:
                        continue
                    if prev is not None and \
                            prev.sum() != (seg * prev).sum():
                        changes += 1
                    if seg.sum() > best_n:
                        best_n, best_mask = seg.sum(), seg
                    prev = seg
                if best_mask is None or \
                        best_n < self.min_region_points or \
                        best_n > self.max_region_points:
                    continue
                mask_object *= 1 - best_mask
                obj_pts = perm[best_mask == 1]

                truncated = (min(det_boxes[i][0], det_boxes[i][1]) < 1
                             or det_boxes[i][2] > w_img - 2
                             or det_boxes[i][3] > h_img - 2)
                fit = self._fit_box(obj_pts, det_boxes[i], l2i, truncated,
                                    ground_sample)
                if fit is None:
                    continue
                fp, loc1, loc2, loc3, y_max, y_min = fit
                corners = np.stack([fp, loc1, loc3, loc2])  # BEV (y, x)
                centre_bev = corners.mean(axis=0)
                angle = np.arctan2(fp[0] - loc1[0], fp[1] - loc1[1])
                # dims from the rectangle edges
                l_ = np.linalg.norm(loc1 - fp)
                w_ = np.linalg.norm(loc2 - fp)
                length, width = max(l_, w_), min(l_, w_)
                if length < 0.5 or length > 15.0 or width < 0.3:
                    continue
                if l_ < w_:
                    angle = np.arctan2(fp[0] - loc2[0], fp[1] - loc2[1])
                out_boxes.append(np.array([
                    centre_bev[1], centre_bev[0], (y_max + y_min) / 2.0,
                    length, width, y_max - y_min, angle], np.float32))
                out_scores.append(1.0)
                out_labels.append(int(det_labels[i]))
        if not out_boxes:
            return empty
        return (np.stack(out_boxes), np.asarray(out_scores, np.float32),
                np.asarray(out_labels, np.int64))
