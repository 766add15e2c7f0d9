"""The port's driver entry points — counterpart of the repository's
`__graft_entry__.py`.

entry(device=None) -> (fn, example_args): the forward step of the flagship
model, TransFusion-LiDAR at tiny shapes (voxelize -> sparse
VoxelResBackBone8x -> HeightCompression -> BEV backbone -> transformer
head), then post_process: fn(detector, batch) -> (boxes, scores, labels,
count); example_args (detector, batch) at batch 1, the weights
`utils/weights.py::init_random_(0)`.

dryrun_multichip(n, device=None): the full TransFusion training step
(Hungarian matching, heatmap targets, the losses, Adam at the reference's
settings) over n processes, one step on tiny shapes; prints
``dryrun_multichip(n) OK: loss=...`` with the backend and the devices it
ran on, and returns the loss. On CUDA each process takes a GPU of its own
under NCCL where there are n GPUs; with fewer, n gloo processes share the
GPUs (the counterpart of the reference's virtual CPU mesh, which it takes
when it has fewer devices than n). Gloo on the CPU runs only when the
caller names the CPU. Both run on CUDA unless the caller names a device,
and raise when CUDA is missing and none is named.

    python -m findnpropagate_torch.graft_entry [--device cpu]

runs entry() and prints the output shapes.
"""

from __future__ import annotations

import argparse
import copy
import math
import socket

import torch
import torch.distributed as dist

from . import resolve_device
from .config import EDict

CLASSES = ["Car", "Pedestrian"]
# the reference's dryrun optimizer (__graft_entry__.py:190-194)
DRYRUN_OPT = {"OPTIMIZER": "adam", "LR": 0.001, "WEIGHT_DECAY": 0.0,
              "GRAD_NORM_CLIP": 10.0}
DRYRUN_STEPS = 10


def tiny_cfgs():
    """(data config, model config) of the flagship model at tiny shapes,
    as the reference's `_tiny_cfgs` (__graft_entry__.py:20-97)."""
    data_cfg = EDict({
        "DATASET": "SyntheticDataset",
        "POINT_CLOUD_RANGE": [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0],
        "SYNTHETIC": {"NUM_SCENES": 8, "NUM_OBJECTS": 8,
                      "NUM_RAW_POINTS": 4000},
        "CAPACITIES": {"MAX_POINTS": 6000, "MAX_GT": 16, "MAX_VOXELS": 4000,
                       "MAX_POINTS_PER_VOXEL": 16},
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z", "intensity"],
            "src_feature_list": ["x", "y", "z", "intensity"],
        },
        "DATA_PROCESSOR": [
            {"NAME": "mask_points_and_boxes_outside_range",
             "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "shuffle_points",
             "SHUFFLE_ENABLED": {"train": True, "test": False}},
            {"NAME": "transform_points_to_voxels",
             "VOXEL_SIZE": [0.2, 0.2, 0.1]},
        ],
    })
    model_cfg = EDict({
        "NAME": "TransFusion",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelResBackBone8x", "USE_BIAS": False,
                        "MAX_VOXELS": 4096, "DENSE_FROM_LEVEL": 2},
        "MAP_TO_BEV": {"NAME": "HeightCompression",
                       "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2, 2],
                        "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [64, 128],
                        "UPSAMPLE_STRIDES": [1, 2],
                        "NUM_UPSAMPLE_FILTERS": [64, 64]},
        "DENSE_HEAD": {
            "NAME": "TransFusionHead",
            "USE_BIAS_BEFORE_NORM": False,
            "NUM_PROPOSALS": 40,
            "HIDDEN_CHANNEL": 64,
            "NUM_CLASSES": 2,
            "NUM_HEADS": 4,
            "NMS_KERNEL_SIZE": 3,
            "FFN_CHANNEL": 128,
            "DROPOUT": 0.1,
            "NUM_HM_CONV": 2,
            "SEPARATE_HEAD_CFG": {
                "HEAD_ORDER": ["center", "height", "dim", "rot"],
                "HEAD_DICT": {
                    "center": {"out_channels": 2, "num_conv": 2},
                    "height": {"out_channels": 1, "num_conv": 2},
                    "dim": {"out_channels": 3, "num_conv": 2},
                    "rot": {"out_channels": 2, "num_conv": 2},
                },
            },
            "TARGET_ASSIGNER_CONFIG": {
                "FEATURE_MAP_STRIDE": 8,
                "DATASET": "nuScenes",
                "GAUSSIAN_OVERLAP": 0.1,
                "MIN_RADIUS": 2,
                "HUNGARIAN_ASSIGNER": {
                    "cls_cost": {"gamma": 2.0, "alpha": 0.25,
                                 "weight": 0.15},
                    "reg_cost": {"weight": 0.25},
                    "iou_cost": {"weight": 0.25},
                },
            },
            "LOSS_CONFIG": {
                "LOSS_WEIGHTS": {"cls_weight": 1.0, "bbox_weight": 0.25,
                                 "hm_weight": 1.0,
                                 "code_weights": [1.0] * 8},
                "LOSS_CLS": {"use_sigmoid": True, "gamma": 2.0,
                             "alpha": 0.25},
            },
            "POST_PROCESSING": {
                "SCORE_THRESH": 0.0,
                "POST_CENTER_RANGE": [-15.0, -15.0, -10.0, 15.0, 15.0, 10.0],
            },
        },
        "POST_PROCESSING": {"RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
                            "SCORE_THRESH": 0.1},
    })
    return data_cfg, model_cfg


def build(batch_size, device, model_cfg=None):
    """(detector, batch) of the tiny model on `device`: the first batch of
    the training loader at `batch_size` (seed 0) as tensors, the detector
    in eval mode with init_random_(0) weights."""
    from .datasets import build_dataloader
    from .models import build_network
    from .utils.weights import init_random_

    data_cfg, default = tiny_cfgs()
    ds, loader, _ = build_dataloader(data_cfg, CLASSES,
                                     batch_size=batch_size, training=True,
                                     seed=0, prefetch=0)
    det = build_network(copy.deepcopy(model_cfg or default),
                        num_class=len(CLASSES), dataset=ds, device=device)
    init_random_(det, seed=0)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in next(iter(loader)).items()
             if k not in ("frame_id", "batch_size")}
    return det, batch


def forward(detector, batch):
    """The eval forward and post_process: (boxes, scores, labels, count)."""
    detector.eval()
    with torch.no_grad():
        d = detector.post_process(detector(batch))
    return d.boxes, d.scores, d.labels, d.count


def entry(device=None):
    """(fn, example_args): fn(detector, batch) -> (boxes, scores, labels,
    count), the example at batch 1 on `device` (CUDA unless named)."""
    return forward, build(1, resolve_device(device))


def train_setup(n, device):
    """(detector, optimizer, global batch of n rows) of the dryrun: the
    tiny model with its head's dropout at 0 (each process draws its own
    masks, so only without dropout is the step over n processes the
    one-process step over the same rows) and the reference's Adam."""
    from .runtime.optimization import build_optimizer

    model_cfg = tiny_cfgs()[1]
    model_cfg.DENSE_HEAD.DROPOUT = 0.0
    det, batch = build(n, device, model_cfg)
    tx, _ = build_optimizer(det.parameters(), EDict(DRYRUN_OPT),
                            DRYRUN_STEPS)
    return det, tx, batch


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_worker(rank, n, port, backend, devices, losses):
    """One process of the dryrun: its row of the global batch, one DDP
    step (runtime/trainer.py), the global loss to `losses` from rank 0."""
    from .runtime.trainer import make_train_step

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        det, tx, batch = train_setup(n, dev)
        rows = {k: v[rank:rank + 1] for k, v in batch.items()}
        loss = float(make_train_step(det, tx)(rows)["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"dryrun_multichip rank {rank}: loss "
                                 f"{loss}")
        if rank == 0:
            losses.put(loss)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> float:
    """One training step of the tiny model over `n_devices` processes (the
    global batch of n rows, one a process); returns its loss."""
    import torch.multiprocessing as mp

    n = int(n_devices)
    dev = resolve_device(device)
    if dev.type == "cuda":
        gpus = torch.cuda.device_count()
        backend = "nccl" if gpus >= n else "gloo"
        devices = [f"cuda:{r % gpus}" for r in range(n)]
    else:
        backend, devices = "gloo", [str(dev)] * n
    losses = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_dryrun_worker,
                       args=(n, _free_port(), backend, devices, losses),
                       nprocs=n, join=True, start_method="spawn")
    loss = losses.get()
    print(f"dryrun_multichip({n}) OK: loss={loss:.4f} ({backend} over "
          f"{', '.join(devices)})")
    return loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry OK:", tuple(tuple(o.shape) for o in out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
