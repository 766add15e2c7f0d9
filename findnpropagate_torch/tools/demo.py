"""Demo CLI — port of tools/demo.py: detections over a folder of raw point
clouds, drawn with matplotlib.

    python -m findnpropagate_torch.tools.demo --cfg_file <yaml>
        --data_path <dir of .bin / .npy> [--ext .bin] [--ckpt PATH]
        [--out_dir demo_out] [--mode bev|3d|none] [--device cuda|cpu]
        [--set KEY VALUE ...]

Each file (a .bin of float32 rows x, y, z, intensity, ring, or a .npy of
rows x, y, z, intensity) goes through the yaml's data processor and the
detector at eval, one scene a batch, and is drawn to <out_dir>/<stem>.png:
`--mode bev` a top-down plot with the boxes' outlines and their
"label:score" tags, `--mode 3d` the mplot3d scene of
visual_utils/pyplot_vis_utils.py, `--mode none` nothing (the
detections only, where matplotlib is missing). `--ckpt` is a checkpoint
of the port's train.py, or a reference (OpenPCDet) TransFusion
checkpoint, which goes through utils/ckpt_import.py; without it the weights are those of
`init_random_(0)`, as tools/test.py's. Runs on CUDA unless `--device`
names another device; raises when CUDA is missing and none is named.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import config as cfg_mod
from .. import resolve_device
from ..datasets.dataset import DatasetTemplate
from ..models import build_network
from ..runtime.trainer import make_eval_step, restore_checkpoint
from ..utils.ckpt_import import load_reference_checkpoint
from ..utils.geometry_np import boxes_to_corners_bev
from ..utils.logging import create_logger
from ..utils.weights import init_random_


class DemoDataset(DatasetTemplate):
    """The `ext` files of `data_path`, sorted, as test-split samples."""

    def __init__(self, dataset_cfg, class_names, data_path, ext=".bin",
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=False, logger=logger)
        self.files = sorted(Path(data_path).glob(f"*{ext}"))
        self.ext = ext

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        f = self.files[index]
        if self.ext == ".bin":
            points = np.fromfile(str(f), np.float32).reshape(-1, 5)[:, :4]
        else:
            points = np.load(str(f))
        return self.prepare_data({"points": points, "frame_id": f.stem})


def draw_bev(points, dets, out_path, pcr):
    """Top-down plot: the points in grey, each detection's outline in red
    with its "label:score" tag. dets = (boxes, scores, labels, count)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(points[:, 0], points[:, 1], s=0.2, c="gray", alpha=0.5)
    boxes, scores, labels, count = dets
    for i in range(int(count)):
        corners = boxes_to_corners_bev(boxes[i:i + 1, :7])[0]
        loop = np.concatenate([corners, corners[:1]], axis=0)
        ax.plot(loop[:, 0], loop[:, 1], "r-", lw=1)
        ax.text(boxes[i, 0], boxes[i, 1],
                f"{int(labels[i])}:{scores[i]:.2f}", fontsize=6,
                color="blue")
    ax.set_xlim(pcr[0], pcr[3])
    ax.set_ylim(pcr[1], pcr[4])
    ax.set_aspect("equal")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def load_weights(path, detector, model_cfg, logger):
    """A port checkpoint ({step, model, optimizer}) or a reference one
    ({model_state: ...} or a bare state dict) into `detector`."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    if "model" in state and "step" in state:
        restore_checkpoint(path, detector)
        return
    report = load_reference_checkpoint(path, detector, model_cfg)
    logger.info(f"reference checkpoint: {len(report['loaded'])} tensors "
                f"loaded, unmatched {report['unmatched_torch']}, "
                f"mismatched {report['mismatched']}")


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--ext", default=".bin")
    parser.add_argument("--out_dir", default="demo_out")
    parser.add_argument("--mode", default="bev",
                        choices=["bev", "3d", "none"],
                        help="bev: top-down plot; 3d: mplot3d scene with "
                        "box wireframes; none: no drawing")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = cfg_mod.cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_mod.cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def main(argv=None):
    """Returns {frame id: (boxes, scores, labels)} of the detections."""
    args, cfg = parse_config(argv)
    device = resolve_device(args.device)
    logger = create_logger()
    dataset = DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.data_path,
                          ext=args.ext, logger=logger)
    logger.info(f"found {len(dataset)} files")
    detector = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                             dataset=dataset, device=device)
    init_random_(detector, seed=0)
    if args.ckpt:
        load_weights(args.ckpt, detector, cfg.MODEL, logger)
    eval_step = make_eval_step(detector)
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    found = {}
    for i in range(len(dataset)):
        sample = dataset[i]
        b = dataset.collate_batch([sample])
        fid = b.pop("frame_id")[0]
        b.pop("batch_size")
        dets = eval_step({k: torch.as_tensor(v).to(device)
                          for k, v in b.items()})
        n = int(dets.count[0])
        boxes = dets.boxes[0, :n].cpu().numpy()
        scores = dets.scores[0, :n].cpu().numpy()
        labels = dets.labels[0, :n].cpu().numpy().astype(int)
        found[fid] = (boxes, scores, labels)
        if args.mode == "3d":
            from .visual_utils.pyplot_vis_utils import save_scene

            save_scene(out_dir / f"{fid}.png", sample["points"],
                       ref_boxes=boxes, ref_scores=scores, ref_labels=labels,
                       bv_range=(pcr[0], pcr[1], pcr[3], pcr[4]))
        elif args.mode == "bev":
            draw_bev(sample["points"], (boxes, scores, labels, n),
                     out_dir / f"{fid}.png", pcr)
        logger.info(f"{fid}: {n} detections")
    return found


if __name__ == "__main__":
    main()
