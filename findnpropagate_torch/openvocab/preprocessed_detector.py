"""Cached 2D VLM detection loaders — port of
findnpropagate_tpu/openvocab/preprocessed_detector.py:18-137:
  * PreprocessedDetector: per-camera COCO-format json predictions
    (OWL-ViT / Detic / GT), category->class remap, keyed by image path.
  * PreprocessedGLIP: a single torch .pth of GLIP predictions for
    all 6 nuScenes cameras + a COCO meta json mapping image paths to ids.

Host-side IO producing the padded numpy arrays the seeker takes
(FrustumProposerOG.propose moves them to the device).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

CAMERA_NAMES = ['CAM_BACK', 'CAM_BACK_LEFT', 'CAM_BACK_RIGHT', 'CAM_FRONT',
                'CAM_FRONT_LEFT', 'CAM_FRONT_RIGHT']
# the seeker iterates cameras in this order (frustum_proposals_v1.py:204)
IMAGE_ORDER = [2, 0, 1, 5, 3, 4]


def pad_detections(boxes, labels, scores, cams, max_dets):
    d = max_dets
    out_boxes = np.zeros((d, 4), np.float32)
    out_labels = np.zeros((d,), np.int32)
    out_scores = np.zeros((d,), np.float32)
    out_cams = np.zeros((d,), np.int32)
    out_mask = np.zeros((d,), bool)
    n = min(len(boxes), d)
    if n:
        order = np.argsort(-np.asarray(scores))[:n]
        out_boxes[:n] = np.asarray(boxes, np.float32)[order]
        out_labels[:n] = np.asarray(labels, np.int32)[order]
        out_scores[:n] = np.asarray(scores, np.float32)[order]
        out_cams[:n] = np.asarray(cams, np.int32)[order]
        out_mask[:n] = True
    return dict(det_boxes=out_boxes, det_labels=out_labels,
                det_scores=out_scores, det_cams=out_cams, det_mask=out_mask)


class PreprocessedDetector:
    """Per-camera COCO-json cached detections (preprocessed_detector.py:112).

    Each json: {"images": [{"id", "file_name"}...],
                "annotations"/"predictions": [{"image_id", "bbox" (xywh or
                xyxy), "category_id", "score"}...],
                "categories": [{"id", "name"}...]}.
    """

    def __init__(self, preds_paths, class_names, box_fmt="xywh",
                 max_dets: int = 64):
        self.class_names = list(class_names)
        self.max_dets = max_dets
        self.box_fmt = box_fmt
        self.by_image = {}       # image filename stem -> list of dets
        self.cat_remap = {}
        for cam_idx, path in enumerate(preds_paths):
            path = Path(path)
            if not path.exists():
                continue
            with open(path) as f:
                data = json.load(f)
            cats = {c["id"]: c["name"] for c in data.get("categories", [])}
            img_files = {im["id"]: im["file_name"] for im in data.get("images", [])}
            anns = data.get("annotations", data.get("predictions", []))
            for a in anns:
                name = cats.get(a["category_id"], str(a["category_id"]))
                if name not in self.class_names:
                    continue
                label = self.class_names.index(name) + 1
                box = np.asarray(a["bbox"], np.float32)
                if self.box_fmt == "xywh":
                    box = np.array([box[0], box[1], box[0] + box[2],
                                    box[1] + box[3]], np.float32)
                fname = img_files.get(a["image_id"], str(a["image_id"]))
                key = Path(fname).stem
                self.by_image.setdefault(key, []).append(
                    (box, label, float(a.get("score", 1.0)), cam_idx)
                )

    def infer(self, image_paths):
        """image_paths: list of 6 per-camera file names for one sample.
        Returns padded det arrays."""
        boxes, labels, scores, cams = [], [], [], []
        for cam_idx, p in enumerate(image_paths):
            for box, label, score, stored_cam in self.by_image.get(
                Path(p).stem, []
            ):
                boxes.append(box)
                labels.append(label)
                scores.append(score)
                cams.append(cam_idx)
        return pad_detections(boxes, labels, scores, cams, self.max_dets)

    def infer_kitti(self, frame_id):
        """Single-camera KITTI lookup keyed by frame id
        (preprocessed_detector.py:244-290 infer_kitti — cam_idx is always 0;
        the reference raises on a missing frame, we return empty)."""
        boxes, labels, scores, cams = [], [], [], []
        for box, label, score, _cam in self.by_image.get(
            Path(str(frame_id)).stem, []
        ):
            boxes.append(box)
            labels.append(label)
            scores.append(score)
            cams.append(0)
        return pad_detections(boxes, labels, scores, cams, self.max_dets)


class PreprocessedGLIP:
    """GLIP .pth + COCO meta json loader (preprocessed_detector.py:7-110):
    the `.pth` is read with torch.load(weights_only=True)."""

    def __init__(self, preds_path, meta_json, class_names, max_dets: int = 64):
        self.class_names = list(class_names)
        self.max_dets = max_dets
        self.preds = torch.load(preds_path, map_location="cpu",
                                weights_only=True)
        with open(meta_json) as f:
            meta = json.load(f)
        self.path_to_img_id = {
            Path(im["file_name"]).stem: im["id"] for im in meta.get("images", [])
        }

    def infer(self, image_paths):
        boxes, labels, scores, cams = [], [], [], []
        for cam_idx, p in enumerate(image_paths):
            img_id = self.path_to_img_id.get(Path(p).stem)
            if img_id is None or img_id not in self.preds:
                continue
            pred = self.preds[img_id]
            b = np.asarray(pred["boxes"], np.float32)
            l = np.asarray(pred["labels"], np.int64)
            s = np.asarray(pred["scores"], np.float32)
            for i in range(len(b)):
                boxes.append(b[i])
                labels.append(int(l[i]))
                scores.append(float(s[i]))
                cams.append(cam_idx)
        return pad_detections(boxes, labels, scores, cams, self.max_dets)
