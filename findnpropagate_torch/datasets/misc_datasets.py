"""The info-pkl loaders of Lyft, Custom, Argo2 and Pandaset — port of
findnpropagate_tpu/datasets/misc_datasets.py on the port's
DatasetTemplate.

  * Lyft: nuScenes-style infos (lidar_path / token / sweeps / gt_boxes /
    gt_names), 5-float .bin sweeps moved by their transform matrices;
    evaluation datasets/lyft_eval.py.
  * Custom: `points/<idx>.npy` + infos with annos {name, gt_boxes_lidar}
    in the lidar frame; evaluation the KITTI protocol of
    datasets/kitti_eval.py over MAP_CLASS_TO_KITTI names.
  * Argo2: infos with point_cloud.velodyne_path and KITTI-style annos with
    precomputed lidar boxes; evaluation datasets/argo2_eval.py.
  * Pandaset: per-frame infos with the path of preprocessed ego-frame
    points and their boxes; no official evaluation.

datasets/misc_infos.py writes the Lyft, Argo2 and Pandaset infos.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class _InfoPklDataset(DatasetTemplate):
    """Shared info-pkl loading skeleton."""

    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, default_root="data", rng=None, hooks=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, logger=logger, root_path=root_path, rng=rng,
            hooks=hooks,
        )
        self.root = Path(root_path or dataset_cfg.get("DATA_PATH",
                                                      default_root))
        split = "train" if training else "test"
        self.infos = []
        for p in dataset_cfg.get("INFO_PATH", {}).get(split, []):
            fp = self.root / p
            if fp.exists():
                with open(fp, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if not self.infos and logger is not None:
            logger.warning(
                f"{type(self).__name__}: no infos under {self.root}")

    def __len__(self):
        return len(self.infos)

    def evaluation(self, det_annos, class_names, **kwargs):
        from .eval_utils import simple_map_eval

        gts = [{"gt_boxes": np.asarray(i.get("gt_boxes", np.zeros((0, 7)))),
                "gt_names": np.asarray(i.get("gt_names", []))}
               for i in self.infos[: len(det_annos)]]
        return simple_map_eval(det_annos, gts, class_names, **kwargs)


class LyftDataset(_InfoPklDataset):
    """nuScenes-style infos + multi-sweep load."""

    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(dataset_cfg, class_names, training, logger,
                         root_path, default_root="data/lyft", rng=rng,
                         hooks=hooks)
        self.max_sweeps = int(dataset_cfg.get("MAX_SWEEPS", 1))

    def evaluation(self, det_annos, class_names, **kwargs):
        """The Lyft mAP (IoU sweep 0.5:0.95) of datasets/lyft_eval.py."""
        from .lyft_eval import lyft_eval

        gts = [{"gt_boxes": np.asarray(i.get("gt_boxes", np.zeros((0, 7)))),
                "gt_names": np.asarray(i.get("gt_names", []))}
               for i in self.infos[: len(det_annos)]]
        return lyft_eval(gts, det_annos, class_names)

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        info = self.infos[index]
        points = np.fromfile(
            str(self.root / info["lidar_path"]), dtype=np.float32
        ).reshape(-1, 5)
        points[:, 4] = 0
        sweeps = [points]
        for sweep in info.get("sweeps", [])[: max_sweeps - 1]:
            pts = np.fromfile(
                str(self.root / sweep["lidar_path"]), dtype=np.float32
            ).reshape(-1, 5)
            tm = sweep.get("transform_matrix")
            if tm is not None:
                pts[:, :3] = pts[:, :3] @ np.asarray(tm)[:3, :3].T \
                    + np.asarray(tm)[:3, 3]
            pts[:, 4] = sweep.get("time_lag", 0.0)
            sweeps.append(pts)
        return np.concatenate(sweeps, axis=0)

    def __getitem__(self, index):
        info = self.infos[index]
        data_dict = {
            "points": self.get_lidar_with_sweeps(index, self.max_sweeps),
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token")},
        }
        if "gt_boxes" in info:
            data_dict["gt_boxes"] = np.asarray(info["gt_boxes"])
            data_dict["gt_names"] = np.asarray(info["gt_names"])
        return self.prepare_data(data_dict)


class CustomDataset(_InfoPklDataset):
    """points/<idx>.npy + annos in the lidar frame."""

    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(dataset_cfg, class_names, training, logger,
                         root_path, default_root="data/custom", rng=rng,
                         hooks=hooks)

    def get_lidar(self, idx):
        return np.load(str(self.root / "points" / f"{idx}.npy"))

    def __getitem__(self, index):
        info = self.infos[index]
        idx = info["point_cloud"]["lidar_idx"]
        data_dict = {"points": self.get_lidar(idx), "frame_id": idx}
        if "annos" in info:
            annos = info["annos"]
            mask = np.asarray(annos["name"]) != "DontCare"
            data_dict["gt_boxes"] = np.asarray(
                annos["gt_boxes_lidar"])[mask]
            data_dict["gt_names"] = np.asarray(annos["name"])[mask]
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        """KITTI AP over `MAP_CLASS_TO_KITTI`-renamed classes, matched in
        the lidar frame by datasets/kitti_eval.py. The infos carry no 2D
        boxes, so kitti_eval's difficulty gate reads a zero-height box for
        every gt and ignores it: every AP is 0, as in the JAX package (the
        reference gives fake [0, 0, 50, 50] boxes, which pass the gate).
        Any other `eval_metric` gives the center-distance mAP of
        eval_utils."""
        if kwargs.get("eval_metric", "kitti") == "kitti":
            from .kitti_eval import kitti_eval

            name_map = dict(self.dataset_cfg.get("MAP_CLASS_TO_KITTI", {}))
            gts = []
            for i in self.infos[: len(det_annos)]:
                annos = i.get("annos", {})
                names = np.asarray(annos.get("name", []))
                boxes = np.asarray(annos.get("gt_boxes_lidar",
                                             np.zeros((0, 7))))
                keep = names != "DontCare"
                gts.append({
                    "name": np.asarray([name_map.get(n, n)
                                        for n in names[keep]]),
                    "gt_boxes_lidar": boxes[keep] if len(boxes) else boxes,
                })
            dets = []
            for d in det_annos:
                d = dict(d)
                if "name" not in d:
                    labels = np.asarray(d.get("labels", []), int)
                    d["name"] = np.asarray(
                        [class_names[l - 1]
                         if 1 <= l <= len(class_names) else "?"
                         for l in labels])
                d["name"] = np.asarray(
                    [name_map.get(n, n) for n in np.asarray(d["name"])])
                dets.append(d)
            kitti_classes = sorted(
                {name_map.get(c, c) for c in class_names})
            return kitti_eval(gts, dets, kitti_classes)
        from .eval_utils import simple_map_eval

        gts = [{"gt_boxes": np.asarray(
                    i.get("annos", {}).get("gt_boxes_lidar",
                                           np.zeros((0, 7)))),
                "gt_names": np.asarray(i.get("annos", {}).get("name", []))}
               for i in self.infos[: len(det_annos)]]
        return simple_map_eval(det_annos, gts, class_names)


class Argo2Dataset(_InfoPklDataset):
    """Infos with velodyne_path + precomputed lidar-frame boxes."""

    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(dataset_cfg, class_names, training, logger,
                         root_path, default_root="data/argo2", rng=rng,
                         hooks=hooks)

    def __getitem__(self, index):
        info = self.infos[index]
        vel = info["point_cloud"]["velodyne_path"]
        points = np.fromfile(str(self.root / vel),
                             dtype=np.float32).reshape(-1, 4)
        data_dict = {"points": points,
                     "frame_id": Path(vel).stem}
        if "annos" in info:
            annos = info["annos"]
            if "gt_boxes_lidar" in annos:
                boxes = np.asarray(annos["gt_boxes_lidar"])
                names = np.asarray(annos["name"])
            else:
                loc = np.asarray(annos["location"])
                dims = np.asarray(annos["dimensions"])  # l, w, h
                rots = np.asarray(annos["rotation_y"])
                boxes = np.concatenate(
                    [loc, dims, rots[:, None]], axis=1).astype(np.float32)
                names = np.asarray(annos["name"])
            mask = names != "DontCare"
            data_dict["gt_boxes"] = boxes[mask]
            data_dict["gt_names"] = names[mask]
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        """The AV2 competition metric of datasets/argo2_eval.py:
        center-distance AP over (0.5,1,2,4) m,
        ATE/ASE/AOE at 2 m, CDS. `eval_metric='simple'` keeps the in-house
        quick mAP."""
        gts = []
        for i in self.infos[: len(det_annos)]:
            annos = i.get("annos", {})
            if "gt_boxes_lidar" in annos:
                boxes = np.asarray(annos["gt_boxes_lidar"])
            else:
                boxes = np.zeros((0, 7))
            gts.append({"gt_boxes": boxes,
                        "gt_names": np.asarray(annos.get("name", [])),
                        "num_points_in_gt": annos.get("num_points_in_gt")})
        if kwargs.get("eval_metric") == "simple":
            from .eval_utils import simple_map_eval

            return simple_map_eval(det_annos, gts, class_names)
        from .argo2_eval import argo2_eval

        for d in det_annos:
            if "name" not in d:
                labels = np.asarray(d.get("labels", []), int)
                d["name"] = np.asarray(
                    [class_names[l - 1] if 1 <= l <= len(class_names)
                     else "?" for l in labels])
        return argo2_eval(gts, det_annos, class_names,
                          max_range_m=float(self.dataset_cfg.get(
                              "EVAL_MAX_RANGE_M", 200.0)))


class PandasetDataset(_InfoPklDataset):
    """Per-frame infos with preprocessed ego-frame points (.npy) and
    lidar-frame boxes."""

    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(dataset_cfg, class_names, training, logger,
                         root_path, default_root="data/pandaset", rng=rng,
                         hooks=hooks)

    def __getitem__(self, index):
        info = self.infos[index]
        pts_path = info.get("points_path") or info.get("lidar_path")
        points = np.load(str(self.root / pts_path)) \
            if str(pts_path).endswith(".npy") else np.fromfile(
                str(self.root / pts_path), dtype=np.float32).reshape(-1, 4)
        frame = f"{info.get('sequence', 'seq')}_{info.get('frame_idx', index)}"
        data_dict = {"points": points.astype(np.float32),
                     "frame_id": frame}
        if "gt_boxes" in info:
            data_dict["gt_boxes"] = np.asarray(info["gt_boxes"])
            data_dict["gt_names"] = np.asarray(info["gt_names"])
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        """Pandaset has no official evaluation: a warning and an empty
        result, as in the reference. `eval_metric='simple'` gives the
        center-distance mAP of eval_utils instead."""
        if kwargs.get("eval_metric") == "simple":
            return super().evaluation(det_annos, class_names)
        if self.logger is not None:
            self.logger.warning(
                "Evaluation is not implemented for Pandaset as there is no "
                "official one. Returning an empty evaluation result.")
        return "", {}
