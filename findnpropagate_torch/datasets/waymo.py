"""WaymoDataset — per-sequence info-pkl loader; port of
findnpropagate_tpu/datasets/waymo.py on the port's DatasetTemplate.

ImageSets sequence lists, per-sequence `<seq>/<seq>.pkl` infos and
`%04d.npy` points (datasets/waymo_infos.py writes both from raw
`.tfrecord` sequences), the NLZ filter unless DISABLE_NLZ_FLAG_ON_POINTS
and tanh of the intensity at load, SAMPLED_INTERVAL subsampling, the
zero-box / `unknown` filter, and the multi-frame path: SEQUENCE_CONFIG
stacks SAMPLE_OFFSET earlier frames into the current one with a trailing
time channel, and USE_PREDBOX adds the first stage's boxes of each frame
(ROI_BOXES_PATH). The evaluation is datasets/waymo_eval.py.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, logger=logger, root_path=root_path, rng=rng,
            hooks=hooks,
        )
        self.root = Path(root_path or dataset_cfg.get("DATA_PATH",
                                                      "data/waymo"))
        self.split = dataset_cfg.get("DATA_SPLIT", {}).get(
            "train" if training else "test", "train")
        self.data_path = self.root / dataset_cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data")
        split_file = self.root / "ImageSets" / f"{self.split}.txt"
        self.sample_sequence_list = (
            [l.strip() for l in split_file.read_text().splitlines()
             if l.strip()] if split_file.exists() else [])
        self.infos = []
        self.seq_name_to_infos = {}
        self.include_waymo_data(logger)

        interval = int(dataset_cfg.get("SAMPLED_INTERVAL", {}).get(
            "train" if training else "test", 1))
        if interval > 1:
            self.infos = self.infos[::interval]

        # multi-frame sequences + first-stage boxes (MPPNet's inputs)
        seq_cfg = dataset_cfg.get("SEQUENCE_CONFIG", {})
        self.seq_enabled = bool(seq_cfg.get("ENABLED", False))
        self.sample_offset = tuple(seq_cfg.get("SAMPLE_OFFSET", (0, 0)))
        self.max_rois = int(dataset_cfg.get("MAX_ROIS", 128))
        self.pred_boxes_dict = {}
        if dataset_cfg.get("USE_PREDBOX", False):
            mode = "train" if training else "test"
            self.pred_boxes_dict = self.load_pred_boxes_to_dict(
                dataset_cfg["ROI_BOXES_PATH"][mode])

    def include_waymo_data(self, logger):
        skipped = 0
        for seq_file in self.sample_sequence_list:
            seq = Path(seq_file).stem
            info_path = self.data_path / seq / f"{seq}.pkl"
            if not info_path.exists():
                skipped += 1
                continue
            with open(info_path, "rb") as f:
                seq_infos = pickle.load(f)
            self.infos.extend(seq_infos)
            self.seq_name_to_infos[seq] = seq_infos
        if logger is not None:
            logger.info(f"WaymoDataset: {len(self.infos)} samples "
                        f"({skipped} sequences missing)")

    def get_lidar(self, sequence_name, sample_idx):
        pts = np.load(self.data_path / sequence_name / f"{sample_idx:04d}.npy")
        points_all, nlz = pts[:, 0:5], pts[:, 5]
        if not self.dataset_cfg.get("DISABLE_NLZ_FLAG_ON_POINTS", False):
            points_all = points_all[nlz == -1]
        points_all[:, 3] = np.tanh(points_all[:, 3])
        return points_all

    # ---- multi-frame sequences (get_sequence_data,
    # transform_prebox_to_current); poses in float64, cast at the end ----

    def load_pred_boxes_to_dict(self, pred_boxes_path):
        """result.pkl -> {seq: {sample_idx: (N, 11) boxes}} with velocity
        converted to per-frame backward motion (-0.1 * v)."""
        with open(pred_boxes_path, "rb") as f:
            pred_dicts = pickle.load(f)
        out = {}
        for det in pred_dicts:
            seq = str(det["frame_id"][:-4]).replace(
                "training_", "").replace("validation_", "")
            idx = int(det["frame_id"][-3:])
            if "name" in det:
                labels = np.array(
                    [self.class_names.index(n) + 1 for n in det["name"]])
            else:
                labels = np.asarray(det["pred_labels"])
            boxes = np.concatenate(
                [det["boxes_lidar"],
                 np.asarray(det["score"])[:, None],
                 labels[:, None]], axis=-1).astype(np.float32)
            out.setdefault(seq, {})[idx] = boxes
        return out

    @staticmethod
    def transform_prebox_to_current(boxes, pose_pre, pose_cur):
        boxes = boxes.copy()
        xyz1 = np.concatenate(
            [boxes[:, :3], np.ones((len(boxes), 1))], axis=-1)
        world = xyz1 @ pose_pre.T
        world[:, 3] = 1.0
        boxes[:, 0:3] = (world @ np.linalg.inv(pose_cur.T))[:, :3]
        if boxes.shape[-1] == 11:
            v3 = np.concatenate(
                [boxes[:, 7:9], np.zeros((len(boxes), 1))], axis=-1)
            vg = v3 @ pose_pre[:3, :3].T
            boxes[:, 7:9] = (vg @ np.linalg.inv(pose_cur[:3, :3].T))[:, :2]
        boxes[:, 6] += np.arctan2(pose_pre[1, 0], pose_pre[0, 0]) \
            - np.arctan2(pose_cur[1, 0], pose_cur[0, 0])
        return boxes

    def _pred_boxes_at(self, seq, idx):
        table = self.pred_boxes_dict.get(seq, {})
        b = table.get(idx)
        if b is None:
            return np.zeros((0, 11), np.float32)
        b = b.copy()
        b[:, 7:9] = -0.1 * b[:, 7:9]
        return b

    def get_sequence_data(self, info, points, seq, sample_idx,
                          load_pred_boxes=False):
        """Concatenate SAMPLE_OFFSET sweeps into the current frame with a
        trailing time channel; optionally stack per-frame pred boxes
        (frame 0 = current, frame i = i sweeps in the past)."""
        pose_cur = np.asarray(info["pose"]).reshape(4, 4)
        lo, hi = self.sample_offset
        pre_idxs = np.clip(sample_idx + np.arange(lo, hi), 0, None)[::-1]
        pts = np.hstack(
            [points, np.zeros((len(points), 1), points.dtype)])
        all_pts = [pts]
        seq_infos = self.seq_name_to_infos.get(seq)
        pred_all = []
        if load_pred_boxes:
            pred_all.append(self._pred_boxes_at(seq, sample_idx))
        for idx_pre in pre_idxs:
            p = self.get_lidar(seq, int(idx_pre))
            pose_pre = np.asarray(
                seq_infos[int(idx_pre)]["pose"]).reshape(4, 4)
            xyz1 = np.concatenate(
                [p[:, :3], np.ones((len(p), 1))], axis=-1)
            world = xyz1 @ pose_pre.T
            world[:, 3] = 1.0
            cur = (world @ np.linalg.inv(pose_cur.T))[:, :3]
            t = 0.1 * (sample_idx - idx_pre) * np.ones((len(p), 1))
            p = np.hstack([cur, p[:, 3:], t]).astype(np.float32)
            keep = ~((np.abs(p[:, 0]) < 1.0) & (np.abs(p[:, 1]) < 1.0))
            all_pts.append(p[keep])
            if load_pred_boxes:
                pb = self._pred_boxes_at(seq, int(idx_pre))
                pred_all.append(self.transform_prebox_to_current(
                    pb, pose_pre, pose_cur))
        points = np.concatenate(all_pts, axis=0).astype(np.float32)
        if not load_pred_boxes:
            return points, None, None, None
        r = self.max_rois
        f = len(pred_all)
        rois = np.zeros((f, r, 9), np.float32)
        scores = np.zeros((f, r), np.float32)
        labels = np.zeros((f, r), np.int32)
        for i, pb in enumerate(pred_all):
            pb = pb[:r]
            rois[i, : len(pb)] = pb[:, :9]
            scores[i, : len(pb)] = pb[:, 9]
            labels[i, : len(pb)] = pb[:, 10].astype(np.int32)
        return points, rois, scores, labels

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = self.infos[index]
        pc = info["point_cloud"]
        points = self.get_lidar(pc["lidar_sequence"], pc["sample_idx"])
        data_dict = {"points": points, "frame_id": info["frame_id"]}
        if self.seq_enabled:
            points, rois, scores, labels = self.get_sequence_data(
                info, points, pc["lidar_sequence"], pc["sample_idx"],
                load_pred_boxes=bool(self.pred_boxes_dict))
            data_dict["points"] = points
            if rois is not None:
                data_dict["roi_boxes"] = rois
                data_dict["roi_scores"] = scores
                data_dict["roi_labels"] = labels
        if "annos" in info:
            annos = info["annos"]
            mask = annos["name"] != "unknown"
            boxes = np.asarray(annos["gt_boxes_lidar"])[mask]
            names = np.asarray(annos["name"])[mask]
            if self.dataset_cfg.get("FILTER_EMPTY_BOXES_FOR_TRAIN", True) \
                    and self.training and "num_points_in_gt" in annos:
                keep = np.asarray(annos["num_points_in_gt"])[mask] > 0
                boxes, names = boxes[keep], names[keep]
            data_dict["gt_boxes"] = boxes[:, :7]
            data_dict["gt_names"] = names
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, eval_metric="waymo",
                   **kwargs):
        """Waymo LEVEL_1 / LEVEL_2 AP and APH (datasets/waymo_eval.py);
        eval_metric='simple' gives the center-distance AP of eval_utils.
        Detections without names count in every class."""
        if eval_metric == "simple":
            from .eval_utils import simple_map_eval

            gts = [{"gt_boxes": info.get("annos", {}).get(
                        "gt_boxes_lidar", np.zeros((0, 7))),
                    "gt_names": info.get("annos", {}).get(
                        "name", np.array([]))}
                   for info in self.infos[: len(det_annos)]]
            return simple_map_eval(det_annos, gts, class_names, **kwargs)
        from .waymo_eval import waymo_eval

        gts = [info.get("annos", {"name": np.array([])})
               for info in self.infos[: len(det_annos)]]
        return waymo_eval(gts, det_annos, class_names)
