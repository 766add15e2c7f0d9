"""NuScenesDataset — info-pkl based nuScenes loader; port of
findnpropagate_tpu/datasets/nuscenes.py on the port's DatasetTemplate.

Infos from the INFO_PATH pickles (datasets/nuscenes_infos.py writes them),
CBGS class-balanced resampling at training (`BALANCED_RESAMPLING`),
multi-sweep aggregation (MAX_SWEEPS - 1 sweeps drawn per frame, moved into
the key frame's lidar frame, their time lag in the fifth feature), the
camera matrices under `CAM_WITHOUT_IMAGE`, and the evaluation: the
`detection_cvpr_2019` protocol (datasets/nuscenes_eval.py) with known /
unknown buckets, or the center-distance AP of datasets/eval_utils.py with
``eval_metric="simple"``. The resampling and the sweep draws come from the
dataset's `rng`, in the reference's order.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, logger=logger, root_path=root_path, rng=rng,
            hooks=hooks,
        )
        self.root = Path(root_path or dataset_cfg.get("DATA_PATH", "data/nuscenes"))
        self.infos = []
        mode = "train" if training else "test"
        for p in dataset_cfg.get("INFO_PATH", {}).get(mode, []):
            fp = self.root / p
            if fp.exists():
                with open(fp, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if not self.infos and logger is not None:
            logger.warning(f"NuScenesDataset: no infos found under {self.root}")

        if training and dataset_cfg.get("BALANCED_RESAMPLING", False) and self.infos:
            self.infos = self.balanced_infos_resampling(self.infos)

        self.max_sweeps = int(dataset_cfg.get("MAX_SWEEPS", 1))
        self.use_camera = "camera" in dataset_cfg.get("USED_DATA_TYPES", []) or \
            dataset_cfg.get("CAM_WITHOUT_IMAGE", False)

    def balanced_infos_resampling(self, infos):
        """CBGS duplication: resample so every class appears in
        ~1/num_classes of the samples."""
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info.get("gt_names", [])):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled = []
        for v in cls_infos.values():
            if len(v) == 0:
                continue
            ratio = frac * duplicated / len(v)
            take = int(len(v) * ratio)
            idx = self.rng.choice(len(v), take)
            sampled.extend([v[i] for i in idx])
        return sampled

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        info = self.infos[index]
        lidar_path = self.root / info["lidar_path"]
        points = np.fromfile(str(lidar_path), dtype=np.float32).reshape(-1, 5)[:, :5]
        # strip ring index, keep (x, y, z, intensity, dt)
        points[:, 4] = 0
        sweep_list = [points]
        for k in self.rng.choice(
            len(info.get("sweeps", [])),
            min(max_sweeps - 1, len(info.get("sweeps", []))),
            replace=False,
        ):
            sweep = info["sweeps"][k]
            pts = np.fromfile(
                str(self.root / sweep["lidar_path"]), dtype=np.float32
            ).reshape(-1, 5)
            pts[:, :3] = (
                pts[:, :3] @ sweep["sensor2lidar_rotation"].T
                + sweep["sensor2lidar_translation"]
            )
            pts[:, 4] = sweep.get("time_lag", 0.0)
            sweep_list.append(pts)
        return np.concatenate(sweep_list, axis=0)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = self.infos[index]
        points = self.get_lidar_with_sweeps(index, self.max_sweeps)
        data_dict = {
            "points": points,
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token")},
        }
        if "gt_boxes" in info:
            data_dict["gt_boxes"] = info["gt_boxes"]
            data_dict["gt_names"] = info["gt_names"]
        if self.use_camera:
            for key in ("camera_intrinsics", "camera2lidar", "lidar2camera",
                        "lidar2image", "camera_imgs"):
                if key in info:
                    data_dict[key] = info[key]
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, eval_metric="nuscenes",
                   **kwargs):
        """The official protocol's mAP / NDS by default, with AP_B / AP_N /
        AR_N given `known_classes`; `eval_metric="simple"` gives the
        center-distance AP of eval_utils. det_annos: one dict per info
        (boxes, scores, labels 1-indexed into class_names, or names).
        Returns (result_str, result_dict)."""
        gts = [
            {"gt_boxes": info.get("gt_boxes", np.zeros((0, 7))),
             "gt_names": info.get("gt_names", np.array([])),
             "num_lidar_pts": info.get("num_lidar_pts", None),
             "gt_attrs": info.get("gt_attrs", None)}
            for info in self.infos
        ]
        if eval_metric == "simple":
            from .eval_utils import simple_map_eval

            slim = [{"gt_boxes": g["gt_boxes"], "gt_names": g["gt_names"]}
                    for g in gts]
            return simple_map_eval(det_annos, slim, class_names, **kwargs)
        from .nuscenes_eval import nuscenes_protocol_eval

        return nuscenes_protocol_eval(det_annos, gts, class_names, **kwargs)
