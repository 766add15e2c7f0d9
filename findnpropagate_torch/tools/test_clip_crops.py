"""CLIP crop-scoring check — port of tools/test_clip_crops.py.

    python -m findnpropagate_torch.tools.test_clip_crops --cfg_file <yaml>
        [--max_samples 8] [--batch_size 1] [--stub]
        [--model_name openai/clip-vit-base-patch32] [--save_dir DIR]
        [--device cuda|cpu] [--set KEY VALUE ...]

Projects each sample's ground-truth boxes into every camera, crops them,
scores the crops with openvocab/box_classification.py::
CLIPBoxClassification and reports the per-class accuracy of the CLIP
label against the ground truth, optionally with matplotlib crop grids
(`--save_dir`). `--stub` replaces the CLIP encoders with a deterministic
stand-in (image features: the mean crop colour; text features: random
unit rows from RandomState(0)), so the projection and crop geometry run
without CLIP's weights. As in the reference, a sample must carry
``images`` and ``trans_lidar_to_image``; no dataset of the repository
gives them, so on those every sample is skipped and the accuracy is over
no box. Runs on CUDA unless `--device` names another device; raises when
CUDA is missing and none is named.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import config as cfg_mod
from .. import resolve_device
from ..datasets import build_dataloader
from ..openvocab.box_classification import (
    CLIPBoxClassification,
    project_boxes_to_cameras,
)
from ..utils.logging import create_logger


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg_file", required=True)
    ap.add_argument("--max_samples", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--stub", action="store_true",
                    help="the deterministic stand-in encoders (no CLIP "
                    "weights needed)")
    ap.add_argument("--model_name", default="openai/clip-vit-base-patch32")
    ap.add_argument("--save_dir", default=None,
                    help="write per-sample crop grids (matplotlib)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--set", dest="set_cfgs", nargs="...", default=None)
    return ap.parse_args(argv)


class StubCLIP:
    """Image features: the mean colour of each crop."""

    def get_image_features(self, pixel_values):
        return pixel_values.mean(dim=(2, 3))


def stub_classifier(class_names, device, model_name=None):
    clip_cls = CLIPBoxClassification(class_names=class_names,
                                     **({"model_name": model_name}
                                        if model_name else {}))
    t = np.random.RandomState(0).standard_normal(
        (len(class_names), 3)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    clip_cls._model = StubCLIP()
    clip_cls._text_features = torch.from_numpy(t).to(device)
    return clip_cls


def score_batch(clip_cls, batch, correct, total, device, save_dir=None,
                done=0, max_samples=None, class_names=()):
    """Relabel every sample's ground truths of one batch into `correct` /
    `total` (per class); returns the number of samples scored."""
    n = 0
    for b in range(batch["gt_boxes"].shape[0]):
        if max_samples is not None and done + n >= max_samples:
            break
        gt = np.asarray(batch["gt_boxes"][b])
        gt_mask = np.asarray(batch["gt_boxes_mask"][b]) \
            if "gt_boxes_mask" in batch else gt[:, 3] > 0
        boxes = gt[gt_mask][:, :7]
        labels = gt[gt_mask][:, -1].astype(np.int64)        # 1-indexed
        if not len(boxes):
            continue
        images = torch.as_tensor(batch["images"][b], device=device)
        l2i = torch.as_tensor(batch["trans_lidar_to_image"][b],
                              device=device)
        new_labels, _ = clip_cls.relabel(
            torch.as_tensor(boxes, device=device), l2i, images)
        new_labels = new_labels.cpu().numpy()
        for li, gl in zip(new_labels, labels):
            total[gl - 1] += 1
            correct[gl - 1] += int(li == gl)
        if save_dir:
            boxes2d = project_boxes_to_cameras(
                torch.as_tensor(boxes, device=device), l2i,
                clip_cls.image_size)[0]
            save_crop_grid(Path(save_dir), done + n, images.cpu().numpy(),
                           boxes2d.cpu().numpy(), labels, new_labels,
                           class_names)
        n += 1
    return n


def main(argv=None):
    """Returns (correct, total) per class."""
    args = parse_args(argv)
    cfg = cfg_mod.cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_mod.cfg_from_list(args.set_cfgs, cfg)
    device = resolve_device(args.device)
    logger = create_logger()

    data_cfg = cfg.DATA_CONFIG
    # the reference's camera-enabled dataset
    data_cfg["CAMERA_CONFIG"] = data_cfg.get(
        "CAMERA_CONFIG", {"USE_CAM": True, "CAM_WITHOUT_IMAGE": False})
    _, loader, _ = build_dataloader(
        data_cfg, cfg.CLASS_NAMES, batch_size=args.batch_size,
        training=False, logger=logger)
    if args.stub:
        clip_cls = stub_classifier(cfg.CLASS_NAMES, device, args.model_name)
    else:
        clip_cls = CLIPBoxClassification(class_names=cfg.CLASS_NAMES,
                                         model_name=args.model_name)

    correct = np.zeros(len(cfg.CLASS_NAMES), np.int64)
    total = np.zeros(len(cfg.CLASS_NAMES), np.int64)
    done = 0
    for batch in loader:
        if done >= args.max_samples:
            break
        if "images" not in batch or "gt_boxes" not in batch:
            logger.warning("sample lacks images/gt_boxes; skipping")
            continue
        done += score_batch(clip_cls, batch, correct, total, device,
                            args.save_dir, done, args.max_samples,
                            cfg.CLASS_NAMES)

    logger.info("CLIP crop classification accuracy (GT boxes -> CLIP label):")
    for i, name in enumerate(cfg.CLASS_NAMES):
        if total[i]:
            logger.info(f"  {name:22s}: {correct[i]}/{total[i]} "
                        f"({100.0 * correct[i] / total[i]:.1f}%)")
    tot = total.sum()
    logger.info(f"  overall: {correct.sum()}/{tot} "
                f"({100.0 * correct.sum() / max(tot, 1):.1f}%)")
    return correct, total


def save_crop_grid(out_dir, idx, images, boxes2d, gt_labels, pred_labels,
                   class_names):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    out_dir.mkdir(parents=True, exist_ok=True)
    ncam = images.shape[0]
    fig, axes = plt.subplots(2, (ncam + 1) // 2, figsize=(16, 7))
    for c, ax in zip(range(ncam), np.asarray(axes).reshape(-1)):
        img = images[c]
        img = (img - img.min()) / max(float(img.max() - img.min()), 1e-6)
        ax.imshow(img)
        for n in range(boxes2d.shape[1]):
            x1, y1, x2, y2 = boxes2d[c, n]
            if x2 <= x1 or y2 <= y1:
                continue
            ok = gt_labels[n] == pred_labels[n]
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                                   edgecolor="lime" if ok else "red",
                                   linewidth=1.2))
            ax.text(x1, y1 - 2, class_names[int(pred_labels[n]) - 1][:10],
                    color="lime" if ok else "red", fontsize=6)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_dir / f"crops_{idx:04d}.png", dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    main()
