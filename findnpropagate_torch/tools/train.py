"""Training CLI — port of tools/train.py.

    python -m findnpropagate_torch.tools.train --cfg_file <yaml>
        [--batch_size N] [--epochs N] [--extra_tag TAG] [--ckpt PATH]
        [--workers N] [--seed N] [--device cuda|cpu] [--set KEY VALUE ...]

Builds the yaml's training loader and detector, the optimizer and its
schedule, resumes from the newest checkpoint of the run's ckpt directory
(the timed mid-epoch ``latest_model`` when it is at least as new) or from
`--ckpt`, adds the yaml's DisableAugmentationHook, and trains the
remaining epochs (OPTIMIZATION's GRAD_ACCUM_STEPS and
CKPT_SAVE_TIME_INTERVAL apply). Logs, tensorboard scalars and checkpoints
go to output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/ under the working
directory. Runs on CUDA unless `--device` names another device; raises
when CUDA is missing and none is named.

`--dist`: data-parallel training, one process per GPU, under torchrun or
SLURM (findnpropagate_torch/tools/scripts/{dist_train,slurm_train}.sh):

    torchrun --nproc_per_node 8 -m findnpropagate_torch.tools.train --dist \
        --cfg_file <yaml>

parallel/mesh.py::init_distributed reads the launcher's environment (NCCL
on CUDA, each process on the GPU of its LOCAL_RANK; gloo with `--device
cpu`). Each process loads BATCH_SIZE_PER_GPU rows of its shard of every
epoch (`shard_id` = rank, `num_shards` = world size); the global batch is
the world size times that, and the step is the one-process step over it
(runtime/trainer.py). Process 0 writes the logs, scalars and checkpoints;
every process resumes from the same checkpoint.

The weights start from `utils/weights.py::init_random_` at `--seed` (the
port has no counterpart of the reference's flax initialisers); the
dataset draws from RandomState(seed), the loader shuffles from seed +
epoch. `--workers` is accepted for the reference's surface and unused, as
there.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from .. import config as cfg_mod
from .. import resolve_device
from ..datasets import build_dataloader
from ..models import build_network
from ..parallel.mesh import init_distributed
from ..runtime.optimization import build_optimizer
from ..runtime.trainer import (
    latest_checkpoint,
    latest_intra_checkpoint,
    restore_checkpoint,
    train_epochs,
)
from ..utils.logging import create_logger
from ..utils.metrics import BatchingSummaryWriter, disable_augmentation_hook
from ..utils.weights import init_random_


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--workers", type=int, default=0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dist", action="store_true",
                        help="multi-process data-parallel training: DDP "
                        "over the torchrun / SLURM environment "
                        "(findnpropagate_torch/tools/scripts/)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = cfg_mod.cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_mod.cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def resume_point(args, ckpt_dir):
    """(checkpoint or None, start epoch, start iteration): `--ckpt`, else
    the newest per-epoch checkpoint, or the timed mid-epoch save where it
    is not older."""
    resume = args.ckpt or latest_checkpoint(ckpt_dir)
    epoch = int(Path(resume).stem.split("_")[-1]) if resume else 0
    intra = None if args.ckpt else latest_intra_checkpoint(ckpt_dir)
    if intra is not None and intra[1] >= epoch:
        return intra
    return resume, epoch, 0


def main(argv=None):
    args, cfg = parse_config(argv)
    device = resolve_device(args.device)
    rank, world = (0, 1)
    if args.dist:
        rank, world = init_distributed(device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS

    output_dir = (Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG
                  / args.extra_tag)
    ckpt_dir = output_dir / "ckpt"
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(
        output_dir / f"log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
        if rank == 0 else None, rank=rank)
    logger.info(f"device: {device}")
    if args.dist:
        logger.info(f"world size {world} "
                    f"({dist.get_backend() if dist.is_initialized() else 'no group'})"
                    f", batch {batch_size} per process, global batch "
                    f"{batch_size * world}")
    cfg_mod.log_config_to_file(cfg, logger=logger)

    dataset, loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=batch_size,
        training=True, seed=args.seed, logger=logger, shard_id=rank,
        num_shards=world)
    detector = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                             dataset=dataset, device=device)
    init_random_(detector, seed=args.seed)
    tx, schedule = build_optimizer(detector.parameters(), cfg.OPTIMIZATION,
                                   len(loader) * epochs)

    resume, start_epoch, start_it = resume_point(args, ckpt_dir)
    if resume:
        logger.info(f"resuming from {resume} (epoch {start_epoch}, it "
                    f"{start_it})")
        restore_checkpoint(resume, detector, tx)

    writer = BatchingSummaryWriter(output_dir / "tensorboard",
                                   logger=logger) if rank == 0 else None
    hooks = []
    if "HOOK" in cfg and "DisableAugmentationHook" in cfg.HOOK:
        hooks.append(disable_augmentation_hook(
            cfg.HOOK.DisableAugmentationHook, loader, epochs, logger=logger))
    train_epochs(
        detector, loader, tx, epochs, logger=logger, ckpt_dir=ckpt_dir,
        start_epoch=start_epoch, start_it=start_it, hooks=hooks,
        writer=writer, schedule=schedule, seed=args.seed,
        accum_steps=int(cfg.OPTIMIZATION.get("GRAD_ACCUM_STEPS", 1)),
        ckpt_save_time_interval=float(
            cfg.OPTIMIZATION.get("CKPT_SAVE_TIME_INTERVAL", 300.0)))
    if writer is not None:
        writer.close()
    logger.info("training done")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
