"""Greedy Box Seeker extraction CLI ("Find") — port of
tools/extract_pseudo_labels.py.

    python -m findnpropagate_torch.tools.extract_pseudo_labels
        --cfg_file <seeker yaml> --save_path DIR [--max_frames N]
        [--device cuda|cpu] [--set KEY VALUE ...]

Runs the seeker named by MODEL.DENSE_HEAD (FrustumProposerOG,
FrustumProposerOGKITTI or FrustumProposerSEG; no training) over the
training split with the augmentations stripped, saves each frame's valid
proposals to a PseudoLabelStore at `--save_path`, stamps it with epoch 0
and logs the running recall where the frames carry ground truth. The 2D
detections come from the yaml's PREDS_PATHS through PreprocessedDetector:
per frame by its `camera_paths` (nuScenes, SEG) or its frame id and
`calib` {P2, R0, V2C} (KITTI).

A DENSE_HEAD named in openvocab/alt_proposers.py's ALT_PROPOSER_REGISTRY
runs that ablation proposer instead (alt mode), built with the head's
PARAMS: GTProposals from the frame's gt_boxes, CLIP2SceneProposer /
CLIP2SceneCCProposer from its `point_seg_labels` (frames without them are
skipped), the others (FGR, FrustumProposer, FrustumClusterProposer,
FrustumDBSCAN, FrustumOV3DET) from the frame's points and its cached 2D
detections.

`extract_frames` is the frame loop, for callers that bring their own
dataset. Runs on CUDA unless `--device` names another device; raises when
CUDA is missing and none is named.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import config as cfg_mod
from .. import resolve_device
from ..datasets import build_dataloader
from ..openvocab.alt_proposers import ALT_PROPOSER_REGISTRY
from ..openvocab.frustum_proposer import FrustumProposerOG
from ..openvocab.preprocessed_detector import PreprocessedDetector
from ..openvocab.pseudo_labels import PseudoLabelStore
from ..utils.geometry_np import boxes_bev_iou_cpu
from ..utils.logging import create_logger


def build_alt_proposer(head_cfg, class_names, device=None):
    """The ablation proposer MODEL.DENSE_HEAD names, with its PARAMS
    (GTProposals is a function of the ground truth alone); the
    FrustumProposer's HDBSCAN runs on `device`."""
    name = head_cfg.NAME
    if name == "GTProposals":
        return ALT_PROPOSER_REGISTRY[name]
    params = dict(head_cfg.get("PARAMS", {}))
    if name == "FrustumProposer":
        params.setdefault("device", device)
    return ALT_PROPOSER_REGISTRY[name](class_names, **params)


def build_seeker(head_cfg, class_names):
    """(seeker, kitti_mode) for MODEL.DENSE_HEAD."""
    if head_cfg.NAME == "FrustumProposerOGKITTI":
        from ..openvocab.frustum_proposer_kitti import FrustumProposerOGKITTI

        return FrustumProposerOGKITTI.from_config(head_cfg, class_names), True
    if head_cfg.NAME == "FrustumProposerSEG":
        from ..openvocab.frustum_proposer_seg import FrustumProposerSEG

        return FrustumProposerSEG.from_config(head_cfg, class_names), False
    return FrustumProposerOG.from_config(head_cfg, class_names), False


def alt_propose(name, proposer, data, detector2d):
    """(boxes, scores, labels) of an ablation proposer on one frame, or
    None where the frame lacks its input."""
    pts = np.asarray(data["points"])[:, :3]
    if name == "GTProposals":
        return proposer(np.asarray(data["gt_boxes"], np.float32))
    if name.startswith("CLIP2Scene"):
        seg = data.get("point_seg_labels")
        return None if seg is None else proposer.propose(pts,
                                                         np.asarray(seg))
    dets = detector2d.infer(data.get("camera_paths", []))
    dm = np.asarray(dets["det_mask"], bool)
    return proposer.propose(
        pts, *[np.asarray(dets[k])[dm] for k in (
            "det_boxes", "det_labels", "det_scores", "det_cams")],
        np.asarray(data["lidar2image"], np.float32))


def extract_frames(dataset, seeker, detector2d, store, kitti_mode=False,
                   max_frames=None, logger=None, device=None, alt=None):
    """Propose on every frame of `dataset` (points padded to its
    max_points), save the valid proposals under the frame's id, and return
    (recalled ground truths, ground truths): a ground truth counts as
    recalled when a proposal overlaps it by BEV IoU > 0.25. With `alt`, a
    name of ALT_PROPOSER_REGISTRY, `seeker` is that ablation proposer and
    every box it proposes is saved; frames without its input are
    skipped."""
    emit = logger.info if logger else print
    recalls, total_gt = 0, 0
    for i in range(len(dataset)):
        if max_frames is not None and i >= max_frames:
            break
        data = dataset[i]
        if alt is not None:
            out = alt_propose(alt, seeker, data, detector2d)
            if out is None:
                emit(f"frame {i}: no point_seg_labels; skipped")
                continue
            boxes, scores, labels = out
            store.save(data["frame_id"], boxes, scores, labels)
            if data.get("gt_boxes") is not None and len(data["gt_boxes"]):
                gt = np.asarray(data["gt_boxes"])[:, :7]
                total_gt += len(gt)
                if len(boxes):
                    iou = boxes_bev_iou_cpu(gt, boxes[:, :7])
                    recalls += int((iou.max(axis=1) > 0.25).sum())
            continue
        P = dataset.max_points
        pts = np.zeros((P, 3), np.float32)
        n = min(len(data["points"]), P)
        pts[:n] = data["points"][:n, :3]
        pmask = np.zeros(P, bool)
        pmask[:n] = True
        if kitti_mode:
            dets = detector2d.infer_kitti(data["frame_id"])
            calib = data["calib"]
            out = seeker.propose(
                pts, pmask, dets["det_boxes"], dets["det_labels"],
                dets["det_scores"], dets["det_mask"],
                np.asarray(calib["P2"], np.float32),
                np.asarray(calib["R0"], np.float32),
                np.asarray(calib["V2C"], np.float32), device=device)
        else:
            dets = detector2d.infer(data.get("camera_paths", []))
            out = seeker.propose(
                pts, pmask, dets["det_boxes"], dets["det_labels"],
                dets["det_scores"], dets["det_cams"], dets["det_mask"],
                np.asarray(data["lidar2image"], np.float32),
                np.asarray(data["camera2lidar"], np.float32),
                np.asarray(data["camera_intrinsics"], np.float32),
                device=device)
        valid = out.valid.cpu().numpy()
        boxes = out.boxes.cpu().numpy()[valid]
        store.save(data["frame_id"], boxes, out.scores.cpu().numpy()[valid],
                   out.labels.cpu().numpy()[valid])
        if data.get("gt_boxes") is not None and len(data["gt_boxes"]):
            gt = np.asarray(data["gt_boxes"])[:, :7]
            total_gt += len(gt)
            if valid.any():
                iou = boxes_bev_iou_cpu(gt, boxes[:, :7])
                recalls += int((iou.max(axis=1) > 0.25).sum())
        if i % 50 == 0:
            emit(f"frame {i}: recall so far {recalls}/{total_gt} "
                 f"({recalls / max(total_gt, 1):.3f})")
    return recalls, total_gt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg_mod.cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_mod.cfg_from_list(args.set_cfgs, cfg)

    logger = create_logger()
    head_cfg = cfg.MODEL.DENSE_HEAD
    alt = head_cfg.NAME if head_cfg.NAME in ALT_PROPOSER_REGISTRY else None
    if alt is not None:
        seeker, kitti_mode = build_alt_proposer(head_cfg, cfg.CLASS_NAMES,
                                                device), False
    else:
        seeker, kitti_mode = build_seeker(head_cfg, cfg.CLASS_NAMES)
    # the seeker reads raw geometry: the augmentation queue is emptied
    # before the loader is built (the pseudo-label hooks are the
    # self-training's, not given here)
    if "DATA_AUGMENTOR" in cfg.DATA_CONFIG:
        cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST = []
    dataset, _, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=1, training=True,
        logger=logger, prefetch=0,
    )
    dataset.data_augmentor = None
    preds_paths = head_cfg.get("PREDS_PATHS", [])
    store = PseudoLabelStore(args.save_path)
    recalls, total_gt = 0, 0
    # GTProposals and CLIP2Scene read no 2D detection
    needs_dets = alt is None or not (alt == "GTProposals"
                                     or alt.startswith("CLIP2Scene"))
    if needs_dets and not preds_paths:
        logger.warning("no PREDS_PATHS configured; nothing to extract")
    else:
        recalls, total_gt = extract_frames(
            dataset, seeker, PreprocessedDetector(preds_paths,
                                                  cfg.CLASS_NAMES)
            if preds_paths else None,
            store, kitti_mode=kitti_mode, max_frames=args.max_frames,
            logger=logger, device=device, alt=alt)
    store.stamp_epoch(0)
    logger.info(f"done; final recall {recalls}/{total_gt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
