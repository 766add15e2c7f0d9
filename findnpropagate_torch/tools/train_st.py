"""Self-training CLI ("Propagate") — port of tools/train_st.py.

    python -m findnpropagate_torch.tools.train_st --cfg_file <yaml>
        [--batch_size N] [--epochs N] [--extra_tag TAG] [--pseudo_path DIR]
        [--st_path DIR] [--st_warmup N] [--st_interval N] [--seed N]
        [--dist] [--device cuda|cpu] [--set KEY VALUE ...]

Builds the training loader with the pseudo-label augmentation hooks and a
second, augmentation-stripped loader over the training split for the
extraction, then runs train_model_st: warm-up epochs on the seeker's
labels (`--pseudo_path`), then, every `--st_interval` epochs, an
extraction into `--st_path` followed by training on both. Logs and
checkpoints go to output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/ under the
working directory. Runs on CUDA unless `--device` names another device;
raises when CUDA is missing and none is named.

`--dist`: data-parallel self-training, one process per GPU, under
torchrun or SLURM (findnpropagate_torch/tools/scripts/dist_train_st.sh;
the SLURM environment as for tools/train.py --dist):

    torchrun --nproc_per_node 8 -m findnpropagate_torch.tools.train_st \
        --dist --cfg_file <yaml>

NCCL on CUDA with each process on the GPU of its LOCAL_RANK, gloo with
`--device cpu` (parallel/mesh.py::init_distributed). The batch keeps this
CLI's convention, the reference's: `--batch_size` (BATCH_SIZE_PER_GPU) is
the global batch B, which the reference loads in one process and shards
over its mesh, where tools/train.py loads B rows per device. At world size
W each process loads B / W rows of its shard (`shard_id` = rank,
`num_shards` = W), so each global step's rows are the one-process step's
rows `order[bB:(b+1)B]`, rank-major, and an epoch has as many steps; a B
that W does not divide is refused. Each process extracts its shard of the
inference loader at B / W rows (openvocab/self_training.py); process 0
writes the logs, checkpoints and the store's epoch stamp.

The weights start from `utils/weights.py::init_random_` at `--seed` (the
port has no counterpart of the reference's flax initialisers); the
datasets draw from RandomState(seed), in every process alike, as every
process of the reference's tools/train.py and tools/train_st.py seeds
numpy's global state with the same `--seed` (:55 and :54); the loader
shuffles from seed + epoch.
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
from ..openvocab import self_training
from ..openvocab.pseudo_labels import PseudoLoader, PseudoProcessor
from ..parallel.mesh import init_distributed
from ..runtime.optimization import build_optimizer
from ..utils.logging import create_logger
from ..utils.weights import init_random_


def inference_loader(cfg, batch_size, hooks, logger=None, prefetch=2,
                     shard_id=0, num_shards=1):
    """(dataset, loader) of the extraction: the training split with the
    augmentations stripped, in order; the shard `shard_id` of
    `num_shards` (every num_shards-th frame), the last short batch
    dropped."""
    dataset, loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=batch_size,
        training=True, logger=logger, hooks=hooks, prefetch=prefetch,
        shard_id=shard_id, num_shards=num_shards,
    )
    dataset.data_augmentor = None
    dataset.training = False
    dataset.data_processor.training = False
    (loader.loader if hasattr(loader, "loader") else loader).shuffle = False
    return dataset, loader


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--pseudo_path", type=str, default=None)
    parser.add_argument("--st_path", type=str, default=None)
    parser.add_argument("--st_warmup", type=int, default=3)
    parser.add_argument("--st_interval", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dist", action="store_true",
                        help="multi-process data-parallel self-training: "
                        "DDP over the torchrun / SLURM environment "
                        "(findnpropagate_torch/tools/scripts/)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg_mod.cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_mod.cfg_from_list(args.set_cfgs, cfg)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    rank, world = (0, 1)
    if args.dist:
        rank, world = init_distributed(device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    if batch_size % world:
        raise ValueError(f"--batch_size {batch_size} is the global batch "
                         f"and must divide by the world size {world}")

    output_dir = (Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG
                  / args.extra_tag)
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(
        output_dir
        / f"log_train_st_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
        if rank == 0 else None, rank=rank)
    logger.info(f"device: {device}")
    if args.dist:
        logger.info(f"world size {world} ({dist.get_backend()}), global "
                    f"batch {batch_size}, {batch_size // world} per process")

    known = list(cfg.get("KNOWN_CLASS_NAMES", cfg.CLASS_NAMES))
    all_names = list(cfg.get("FULL_CLASS_NAMES", cfg.CLASS_NAMES))
    st_path = args.st_path or str(output_dir / "st_labels")
    ploader = PseudoLoader(
        known, pseudo_path=args.pseudo_path, self_train_path=st_path,
        all_class_names=all_names,
    )
    hooks = self_training.register_pseudo_hooks(ploader)
    processor = PseudoProcessor(known, self_training_folder=st_path,
                                all_class_names=all_names)

    rows = batch_size // world
    dataset, train_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=rows,
        training=True, seed=args.seed, logger=logger, hooks=hooks,
        shard_id=rank, num_shards=world,
    )
    _, inf_loader = inference_loader(cfg, rows, hooks, logger=logger,
                                     shard_id=rank, num_shards=world)

    detector = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                             dataset=dataset, device=device)
    init_random_(detector, seed=args.seed)
    total_steps = len(train_loader) * epochs
    tx, _ = build_optimizer(detector.parameters(), cfg.OPTIMIZATION,
                            total_steps)

    self_training.train_model_st(
        detector, train_loader, inf_loader, tx, epochs, processor,
        logger=logger, ckpt_dir=output_dir / "ckpt",
        st_warmup=args.st_warmup, st_interval=args.st_interval,
        seed=args.seed,
        ckpt_save_time_interval=float(
            cfg.OPTIMIZATION.get("CKPT_SAVE_TIME_INTERVAL", 300.0)),
    )
    logger.info("self-training done")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
