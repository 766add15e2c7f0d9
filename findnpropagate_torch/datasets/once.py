"""ONCEDataset — info-pkl loader for the ONCE benchmark; port of
findnpropagate_tpu/datasets/once.py on the port's DatasetTemplate.

Split info pickles (datasets/misc_infos.py::create_once_infos writes them),
per-sequence lidar bins (data/<seq>/lidar_roof/<frame>.bin), annos in the
lidar frame; training keeps the annotated frames only. The evaluation is
datasets/once_eval.py.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class ONCEDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, logger=logger, root_path=root_path, rng=rng,
            hooks=hooks,
        )
        self.root = Path(root_path or dataset_cfg.get("DATA_PATH",
                                                      "data/once"))
        split = "train" if training else "test"
        self.infos = []
        for p in dataset_cfg.get("INFO_PATH", {}).get(split, []):
            fp = self.root / p
            if fp.exists():
                with open(fp, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if training:
            self.infos = [i for i in self.infos if "annos" in i]
        if not self.infos and logger is not None:
            logger.warning(f"ONCEDataset: no infos under {self.root}")

    def get_lidar(self, sequence_id, frame_id):
        fp = self.root / "data" / str(sequence_id) / "lidar_roof" / \
            f"{frame_id}.bin"
        return np.fromfile(str(fp), dtype=np.float32).reshape(-1, 4)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = self.infos[index]
        points = self.get_lidar(info["sequence_id"], info["frame_id"])
        data_dict = {"points": points, "frame_id": info["frame_id"]}
        if "annos" in info:
            annos = info["annos"]
            data_dict["gt_boxes"] = np.asarray(annos["boxes_3d"])[:, :7]
            data_dict["gt_names"] = np.asarray(annos["name"])
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, eval_metric="once",
                   **kwargs):
        """The ONCE protocol (datasets/once_eval.py), which reads the
        detections' boxes_3d / name / score; eval_metric='simple' gives the
        center-distance AP of eval_utils."""
        if eval_metric == "simple":
            from .eval_utils import simple_map_eval

            gts = [{"gt_boxes": np.asarray(
                        info.get("annos", {}).get("boxes_3d",
                                                  np.zeros((0, 7)))),
                    "gt_names": np.asarray(
                        info.get("annos", {}).get("name", []))}
                   for info in self.infos[: len(det_annos)]]
            return simple_map_eval(det_annos, gts, class_names, **kwargs)
        from .once_eval import once_eval

        gts = [info.get("annos", {"name": np.array([]),
                                  "boxes_3d": np.zeros((0, 7))})
               for info in self.infos[: len(det_annos)]]
        return once_eval(gts, det_annos, list(class_names))
