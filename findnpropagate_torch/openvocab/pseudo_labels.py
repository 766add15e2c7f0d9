"""Remote Propagator — pseudo-label store, loader, copy-paste sampler and
processor; port of findnpropagate_tpu/openvocab/pseudo_labels.py.

  * PseudoProcessor: relabels known GT labels into the full class space,
    concatenates GT + pseudo boxes, and saves per-frame predictions with
    the world augmentations inverted (`reverse_augmentation`).
  * PseudoLoader: per-frame load of the seeker's pseudo labels and of the
    previous round's self-train labels, per-class score filtering by
    max(top-k threshold, EMA score, min_score), BEV-NMS merge, removal of
    boxes overlapping the ground truth or the ego box.
  * PseudoSampler + ObjectSample: per-unknown-class confidence queues of
    box-relative point sets; copy-paste sampling with jittered re-placement
    and collision rejection.

All of it is host-side numpy (dataloader work) feeding the model on the
device, as in the reference. The store writes the same npz files as the
reference's, so either package reads what the other wrote. The sampler's
random draws come from the `rng` it is called with (the dataset's
np.random.RandomState), in the reference's order.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..utils import geometry_np as G

NUSCENES_CLASSES = ['car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                    'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                    'traffic_cone']
EGO_VEHICLE = np.array(
    [[0, -1.0, (-5.0 + 3.0) / 2.0, 5.0, 3.0, 8.0, np.pi / 2.0]], np.float32
)


def bev_nms_cpu(boxes, scores, thresh):
    """Greedy BEV NMS on host (approximate AABB-of-rotated-corners IoU,
    mirroring the loader's cheap CPU path). Returns kept indices sorted by
    score."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-scores)
    iou = G.boxes_bev_iou_cpu(boxes[:, :7], boxes[:, :7])
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > thresh
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def valid_boxes(boxes):
    return boxes[np.abs(boxes).sum(axis=-1) > 0]


def remove_empty(boxes):
    mask = (boxes[:, 3] > 0) & (boxes[:, 4] > 0) & (boxes[:, 5] > 0)
    return boxes[mask], mask


# --------------------------------------------------------------- label store

class PseudoLabelStore:
    """Per-frame npz label store: <folder>/<frame_id>.npz with boxes,
    scores and labels, and <folder>/epoch.txt for the epoch stamp. A
    missing or corrupt frame loads as empty and is remembered in
    `missing`."""

    def __init__(self, folder):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.missing = set()

    def save(self, frame_id, boxes, scores, labels):
        np.savez(
            self.folder / f"{frame_id}.npz",
            boxes=np.asarray(boxes, np.float32),
            scores=np.asarray(scores, np.float32),
            labels=np.asarray(labels, np.int32),
        )

    def load(self, frame_id):
        path = self.folder / f"{frame_id}.npz"
        try:
            data = np.load(path)
            return data["boxes"], data["scores"], data["labels"]
        except Exception:
            self.missing.add(str(frame_id))
            return (np.zeros((0, 7), np.float32), np.zeros((0,), np.float32),
                    np.zeros((0,), np.int32))

    def stamp_epoch(self, epoch):
        (self.folder / "epoch.txt").write_text(str(int(epoch)))

    def stamped_epoch(self):
        p = self.folder / "epoch.txt"
        return int(p.read_text()) if p.exists() else -1


# ------------------------------------------------------------ aug inversion

def reverse_augmentation(boxes, data_dict):
    """Invert recorded world augs (AugReverse, pseudo_processor.py:56-108):
    translate -> scale -> rotate -> flips, in reverse application order."""
    boxes = boxes.copy()
    if len(boxes) == 0:
        return boxes
    t = data_dict.get("noise_translate")
    if t is not None:
        boxes[:, :3] -= np.asarray(t)
    s = data_dict.get("noise_scale")
    if s is not None and s != 0:
        boxes[:, :6] /= s
        if boxes.shape[1] > 8:
            boxes[:, 7:9] /= s
    r = data_dict.get("noise_rot")
    if r is not None:
        boxes = G.rotate_boxes_along_z(boxes, -float(r))
    if data_dict.get("flip_y"):
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = -(boxes[:, 6] + np.pi)
        if boxes.shape[1] > 8:
            boxes[:, 7] = -boxes[:, 7]
    if data_dict.get("flip_x"):
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        if boxes.shape[1] > 8:
            boxes[:, 8] = -boxes[:, 8]
    return boxes


# ------------------------------------------------------------ ObjectSample

class ObjectSample:
    """A queued pseudo object: box-relative points + confidence
    (pseudo_loader.py:57-216)."""

    def __init__(self, relative_points, box, conf):
        self.conf = float(conf)
        self.num_points = relative_points.shape[0]
        box = np.asarray(box, np.float32).reshape(-1)
        self.label = int(box[-1])
        self.x, self.y, self.z = box[0:3]
        self.l, self.w, self.h = box[3:6]
        self.ry = float(box[6])
        self.points = relative_points  # (N, F) xyz relative to centered box

    def dropout_points(self, dropout=0.5, min_points=5, *, rng):
        if self.points.shape[0] <= min_points * 2:
            return self.points.copy()
        pts = self.points.copy()
        if rng.rand() < dropout:
            n = len(pts)
            keep = rng.randint(n // 2, n)
            idx = rng.randint(0, n, size=keep)
            pts = pts[idx]
        return pts

    def get_sample_points(self, sample_box, dropout=0.5, *, rng):
        pts = self.dropout_points(dropout, rng=rng)
        out = pts.copy()
        out[:, :3] = G.rotate_points_along_z(pts[:, :3], float(sample_box[0, 6]))
        out[:, :3] += sample_box[0, 0:3]
        return out

    def sample(self, gt_boxes, pseudo_boxes, max_iou=0.1, dropout=0.5,
               min_dist=4.5, rot_noise=np.pi / 4.0, trans_noise=2.0, *, rng):
        for _ in range(10):
            dx, dy, dz = rng.randn(3)
            x = self.x + trans_noise * dx
            y = self.y + trans_noise * dy
            z = self.z + trans_noise * dz
            if np.linalg.norm([x, y, z]) < min_dist:
                continue
            alpha = self.ry + rot_noise * rng.rand()
            box = np.array(
                [[x, y, z, self.l, self.w, self.h, alpha, self.label]],
                np.float32,
            )
            if len(gt_boxes):
                if G.boxes_bev_iou_cpu(box[:, :7], gt_boxes[:, :7]).max() >= max_iou:
                    continue
            if len(pseudo_boxes):
                if G.boxes_bev_iou_cpu(box[:, :7], pseudo_boxes[:, :7]).max() >= max_iou:
                    continue
            return box, self.get_sample_points(box, dropout=dropout, rng=rng)
        return None, None


# ------------------------------------------------------------ PseudoSampler

class PseudoSampler:
    """Per-unknown-class confidence queues + copy-paste placement
    (pseudo_loader.py:319-485)."""

    def __init__(self, unknown_class_labels, known_class_labels,
                 max_queue_size_per_class=60, min_pts=5, min_dist=4.5,
                 rot_noise=np.pi / 4.0, trans_noise=2.0,
                 known_to_unknown_ratio=1.0, queue_metric="conf",
                 validate_pseudos=True):
        self.unknown_class_labels = list(unknown_class_labels)
        self.known_class_labels = list(known_class_labels)
        self.unknown_queue: Dict[int, List[ObjectSample]] = {
            l: [] for l in self.unknown_class_labels
        }
        self.max_queue_size_per_class = max_queue_size_per_class
        self.min_pts = min_pts
        self.min_dist = min_dist
        self.rot_noise = rot_noise
        self.trans_noise = trans_noise
        self.known_to_unknown_ratio = known_to_unknown_ratio
        self.queue_metric = queue_metric
        self.validate_pseudos = validate_pseudos
        self.seen_per_class_ema: Dict[int, float] = {
            l: 0.0 for l in self.unknown_class_labels
        }
        self.ego_vehicle = EGO_VEHICLE

    def calc_seen_per_class(self, pseudo_boxes, gt_boxes, mom=0.99):
        """EMA of per-class pseudo counts (pseudo_loader.py:258)."""
        labels = pseudo_boxes[:, -1].astype(int) if len(pseudo_boxes) else np.zeros(0, int)
        for l in self.unknown_class_labels:
            cnt = float((labels == l).sum())
            self.seen_per_class_ema[l] = (
                mom * self.seen_per_class_ema[l] + (1 - mom) * cnt
            )

    def __call__(self, data_dict, pseudo_boxes, pseudo_scores, gt_boxes,
                 sample_buffer_num=5, fix_cp=None, *, rng):
        self.calc_seen_per_class(pseudo_boxes, gt_boxes)
        samples_per_label = {l: len(q) for l, q in self.unknown_queue.items()}

        num_scaled = max(
            int(gt_boxes.shape[0] * self.known_to_unknown_ratio),
            pseudo_boxes.shape[0],
        )
        num_proposals = num_scaled + (fix_cp if fix_cp is not None
                                      else sample_buffer_num)

        cur_points = data_dict["points"]
        batch_points = [cur_points]

        if pseudo_boxes.size == 0:
            return pseudo_boxes, np.zeros((0,), bool)

        gt_plus_ego = np.concatenate(
            [gt_boxes[:, :7], self.ego_vehicle], axis=0
        ) if len(gt_boxes) else self.ego_vehicle

        inside = G.points_in_boxes_mask(cur_points[:, :3], pseudo_boxes[:, :7])
        num_pts_per_box = inside.sum(axis=1)

        if self.queue_metric == "num_pts":
            idx_sorted = np.argsort(-num_pts_per_box)
        else:
            idx_sorted = np.argsort(-pseudo_scores)

        max_num_per_unknown = gt_boxes.shape[0] / max(
            len(self.known_class_labels), 1
        )
        curr_num_per_class = {l: 0 for l in self.unknown_class_labels}
        valid_idx = []
        for idx in idx_sorted:
            box = pseudo_boxes[idx]
            lbl = int(box[-1])
            if lbl not in self.unknown_queue:
                if not self.validate_pseudos:
                    valid_idx.append(idx)
                continue
            if not self.validate_pseudos:
                valid_idx.append(idx)
            pt_mask = inside[idx]
            rel = cur_points[pt_mask].copy()
            if len(rel):
                rel[:, :3] -= box[0:3]
                rel[:, :3] = G.rotate_points_along_z(rel[:, :3], -float(box[6]))
            if rel.shape[0] < self.min_pts:
                continue
            if np.linalg.norm(box[:3]) < self.min_dist:
                continue
            curr_num_per_class[lbl] += 1
            if self.validate_pseudos:
                valid_idx.append(idx)
            conf = float(pseudo_scores[idx])
            queue = self.unknown_queue[lbl]
            if samples_per_label[lbl] >= self.max_queue_size_per_class:
                if self.queue_metric == "num_pts":
                    rpl = int(np.argmin([s.num_points for s in queue]))
                    queue[rpl] = ObjectSample(rel, box, conf)
                else:
                    confs = np.array([s.conf for s in queue])
                    rpl = int(np.argmin(confs))
                    if conf > confs[rpl]:
                        queue[rpl] = ObjectSample(rel, box, conf)
            else:
                queue.append(ObjectSample(rel, box, conf))
                samples_per_label[lbl] += 1

        num_pseudos = len(valid_idx)
        pseudos_out = np.zeros((num_proposals, 8), np.float32)
        pseudos_out[:num_pseudos] = pseudo_boxes[valid_idx]
        sample_mask = np.zeros((num_proposals,), bool)

        num_samples = max(num_proposals - num_pseudos, 0)
        if fix_cp is not None:
            num_samples = fix_cp
        if num_samples <= 0 or max(samples_per_label.values(), default=0) == 0:
            return pseudos_out[:num_pseudos], sample_mask[:num_pseudos]

        sample_idx = num_pseudos
        curr_sampled = {l: 0 for l in self.unknown_class_labels}
        for _ in range(num_samples):
            lbl = int(rng.choice(self.unknown_class_labels))
            if samples_per_label[lbl] == 0:
                continue
            if curr_num_per_class[lbl] + curr_sampled[lbl] >= max_num_per_unknown:
                continue
            qi = int(rng.choice(len(self.unknown_queue[lbl])))
            box, pts = self.unknown_queue[lbl][qi].sample(
                gt_plus_ego, pseudos_out[:sample_idx],
                min_dist=self.min_dist, rot_noise=self.rot_noise,
                trans_noise=self.trans_noise, rng=rng,
            )
            if box is None or sample_idx >= num_proposals:
                continue
            pseudos_out[sample_idx] = box
            sample_mask[sample_idx] = True
            curr_sampled[lbl] += 1
            sample_idx += 1
            batch_points.append(pts)

        data_dict["points"] = np.concatenate(batch_points, axis=0)
        return pseudos_out[:sample_idx], sample_mask[:sample_idx]


# ------------------------------------------------------------- PseudoLoader

class PseudoLoader:
    """Loads + filters frustum/self-train pseudos per frame
    (pseudo_loader.py:487-840)."""

    def __init__(self, known_class_names, pseudo_path=None,
                 self_train_path=None, all_class_names=None, min_score=0.1,
                 pseudo_nms_thresh=1e-7, max_selftrain_per_class=None,
                 fix_cp=None, mom=0.9, sampler_kwargs=None):
        self.all_class_names = list(all_class_names or NUSCENES_CLASSES)
        self.known_class_names = list(known_class_names)
        self.num_classes = len(self.all_class_names)
        self.min_score = min_score
        self.pseudo_nms_thresh = pseudo_nms_thresh
        self.max_selftrain_per_class = max_selftrain_per_class
        self.fix_cp = fix_cp
        self.mom = mom

        self.class_labels = list(range(1, self.num_classes + 1))
        self.unknown_class_labels = [
            i + 1 for i, n in enumerate(self.all_class_names)
            if n not in self.known_class_names
        ]
        self.known_class_labels = [
            l for l in self.class_labels if l not in self.unknown_class_labels
        ]
        self.unknown_score_ema = {l: 0.0 for l in self.unknown_class_labels}
        self.ego_vehicle = EGO_VEHICLE

        self.frustum_store = PseudoLabelStore(pseudo_path) if pseudo_path else None
        self.selftrain_store = (
            PseudoLabelStore(self_train_path) if self_train_path else None
        )
        self.sampler = PseudoSampler(
            self.unknown_class_labels, self.known_class_labels,
            **(sampler_kwargs or {}),
        )

    # -- filtering (pseudo_loader.py:595-664) --

    def _filter(self, boxes, scores, labels, filter_by_score, unknowns_only=True):
        if unknowns_only:
            mask = np.zeros(len(labels), bool)
            unknown_threshs = {l: 0.0 for l in self.unknown_class_labels}
            if self.max_selftrain_per_class is not None:
                for l in self.unknown_class_labels:
                    s = scores[labels == l]
                    if s.size == 0:
                        continue
                    if s.size < self.max_selftrain_per_class:
                        unknown_threshs[l] = float(s.min())
                    else:
                        k = min(self.max_selftrain_per_class, s.size) - 1
                        unknown_threshs[l] = float(np.sort(s)[::-1][k])
            for i, l in enumerate(labels):
                l = int(l)
                mask[i] = l in self.unknown_class_labels
                if mask[i] and filter_by_score:
                    self.unknown_score_ema[l] = (
                        self.unknown_score_ema[l] * self.mom
                        + (1 - self.mom) * scores[i]
                    )
                    thr = max(unknown_threshs[l], self.unknown_score_ema[l],
                              self.min_score)
                    mask[i] &= scores[i] >= thr
            boxes, scores, labels = boxes[mask], scores[mask], labels[mask]
        if len(boxes) == 0:
            return np.zeros((0, 8), np.float32), np.zeros((0,), np.float32)
        out = np.zeros((len(boxes), 8), np.float32)
        out[:, :7] = boxes[:, :7]
        out[:, 7] = labels
        return out, scores

    def load_frustum_pseudos(self, data_dict):
        frame_id = data_dict.get("frame_id")
        boxes, scores, labels = self.frustum_store.load(frame_id)
        pseudo_boxes, pseudo_scores = self._filter(
            boxes, scores, labels, filter_by_score=False
        )
        data_dict["pseudo_boxes"] = pseudo_boxes
        data_dict["pseudo_scores"] = pseudo_scores
        data_dict["pseudo_samples_mask"] = np.zeros(len(pseudo_boxes), bool)
        return data_dict

    def load_selftrain_pseudos(self, data_dict):
        frame_id = data_dict.get("frame_id")
        st_boxes, st_scores, st_labels = self.selftrain_store.load(frame_id)
        st, st_s = self._filter(st_boxes, st_scores, st_labels,
                                filter_by_score=True)
        frust = data_dict.get("pseudo_boxes", np.zeros((0, 8), np.float32))
        frust_s = data_dict.get("pseudo_scores", np.zeros((0,), np.float32))
        boxes = np.concatenate([frust, st], axis=0)
        scores = np.concatenate([frust_s, st_s], axis=0)

        # BEV-NMS merge (:755) then GT/ego overlap removal (:767-789)
        keep = bev_nms_cpu(boxes, scores, thresh=0.1)
        boxes, scores = boxes[keep], scores[keep]

        gt = data_dict.get("gt_boxes", np.zeros((0, 8), np.float32))
        gt_plus_ego = np.concatenate([gt[:, :7], self.ego_vehicle], axis=0) \
            if len(gt) else self.ego_vehicle
        if len(boxes):
            ious = G.boxes_bev_iou_cpu(boxes[:, :7], gt_plus_ego)
            m = ious.max(axis=1) <= self.pseudo_nms_thresh
            boxes, scores = boxes[m], scores[m]
        boxes, m = remove_empty(boxes)
        scores = scores[m]
        data_dict["pseudo_boxes"] = boxes
        data_dict["pseudo_scores"] = scores
        data_dict["pseudo_samples_mask"] = np.zeros(len(boxes), bool)
        return data_dict

    def unknowns_copy_paste(self, data_dict, *, rng):
        boxes = data_dict.get("pseudo_boxes", np.zeros((0, 8), np.float32))
        scores = data_dict.get("pseudo_scores", np.zeros((0,), np.float32))
        gt = data_dict.get("gt_boxes", np.zeros((0, 8), np.float32))
        out, mask = self.sampler(
            data_dict, boxes, scores, gt, fix_cp=self.fix_cp, rng=rng
        )
        data_dict["pseudo_boxes"] = out
        data_dict["pseudo_samples_mask"] = mask
        data_dict["pseudo_scores"] = np.concatenate(
            [scores[: int((~mask).sum())],
             np.ones(int(mask.sum()), np.float32)]
        ) if len(out) else scores[:0]
        return data_dict


# ----------------------------------------------------------- PseudoProcessor

class PseudoProcessor:
    """Train-time GT+pseudo merger and prediction saver
    (pseudo_processor.py:110-401)."""

    def __init__(self, known_class_names, self_training_folder=None,
                 all_class_names=None, sample_iou_thresh=0.01):
        self.all_class_names = list(all_class_names or NUSCENES_CLASSES)
        self.known_class_names = list(known_class_names)
        self.num_classes = len(self.all_class_names)
        self.sample_iou_thresh = sample_iou_thresh
        self.self_training = self_training_folder is not None
        self.store = (
            PseudoLabelStore(self_training_folder) if self.self_training else None
        )
        self.gt_known_to_full = {
            i + 1: j + 1
            for i, kn in enumerate(self.known_class_names)
            for j, an in enumerate(self.all_class_names) if kn == an
        }
        self.unknown_labels = [
            i + 1 for i, n in enumerate(self.all_class_names)
            if n not in self.known_class_names
        ]
        self.forward_pseudo_stats = {}

    def relabel_lut(self):
        """(num_known+1,) LUT mapping known label -> full-space label."""
        lut = np.arange(len(self.known_class_names) + 1, dtype=np.int32)
        for k, v in self.gt_known_to_full.items():
            lut[k] = v
        return lut

    def relabel_gt_boxes(self, gt_boxes):
        """(B, N, 8+) known-label gt -> full-label space (:166-184)."""
        lut = self.relabel_lut()
        out = gt_boxes.copy()
        labels = gt_boxes[..., -1].astype(np.int32)
        labels = np.clip(labels, 0, len(lut) - 1)
        out[..., -1] = lut[labels].astype(gt_boxes.dtype)
        return out

    def combine_gt_with_pseudos(self, gt_boxes, pseudo_boxes):
        """(B, N, C), (B, M, C) -> (B, <=N+M, C) padded concat (:186-275)."""
        b, n, c = gt_boxes.shape
        m = pseudo_boxes.shape[1]
        ret = np.zeros((b, n + m, c), gt_boxes.dtype)
        max_num = 0
        stats = {"num_gt": 0, "num_pseudo": 0}
        for i in range(b):
            g = valid_boxes(gt_boxes[i])
            p = valid_boxes(pseudo_boxes[i])
            stats["num_gt"] += len(g)
            stats["num_pseudo"] += len(p)
            ret[i, : len(g)] = g
            ret[i, len(g) : len(g) + len(p), : p.shape[-1] - 1] = p[:, :-1]
            ret[i, len(g) : len(g) + len(p), -1] = p[:, -1]
            max_num = max(max_num, len(g) + len(p))
        for k in stats:
            self.forward_pseudo_stats[k] = stats[k] / max(b, 1)
        return ret[:, : max(max_num, 1)]

    def save_predictions(self, data_dicts, detections):
        """Per-sample: drop predictions overlapping copy-paste samples,
        invert world augs, save to the store (:277-372)."""
        for dd, det in zip(data_dicts, detections):
            boxes = np.asarray(det["pred_boxes"], np.float32)
            scores = np.asarray(det["pred_scores"], np.float32)
            labels = np.asarray(det["pred_labels"], np.int32)
            sample_mask = dd.get("pseudo_samples_mask")
            pseudos = dd.get("pseudo_boxes")
            if (
                sample_mask is not None and pseudos is not None
                and sample_mask.any() and len(boxes)
            ):
                sample_boxes = pseudos[sample_mask]
                ious = G.boxes_bev_iou_cpu(boxes[:, :7], sample_boxes[:, :7])
                keep = ious.max(axis=1) <= self.sample_iou_thresh
                boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
            boxes = reverse_augmentation(boxes, dd)
            self.store.save(dd["frame_id"], boxes, scores, labels)

    def stamp_epoch(self, epoch):
        if self.store:
            self.store.stamp_epoch(epoch)
