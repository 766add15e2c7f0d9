"""Training scalars and the augmentation hook — port of
findnpropagate_tpu/utils/metrics.py:15-139.

`AverageMeter`; `SummaryWriter`, tensorboardX's scalar writer, a no-op
(logged once) when tensorboardX is not importable; `BatchingSummaryWriter`,
the reference's batching writer (scalars buffered until a tag repeats, then
flushed as one step, also to wandb when it is importable and a project is
named); `disable_augmentation_hook`, the epoch hook that strips the listed
augmentations for the last NUM_LAST_EPOCHS.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path


class AverageMeter:
    """Running value, sum, count and mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class SummaryWriter:
    """tensorboardX scalar writer on rank 0; writes nothing (and says so
    once in the log) where tensorboardX is not importable."""

    def __init__(self, log_dir, rank: int = 0, logger=None):
        self.rank = rank
        self._tb = None
        if rank != 0:
            return
        try:
            from tensorboardX import SummaryWriter as TBWriter
        except ImportError:
            (logger or logging.getLogger(__name__)).info(
                "tensorboardX is not installed: no scalars are written to "
                f"{log_dir}")
            return
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self._tb = TBWriter(log_dir=str(log_dir))

    def add_scalar(self, tag, value, step):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()


class BatchingSummaryWriter(SummaryWriter):
    """Scalars buffered until a tag repeats, then the buffer flushed as one
    logical step; also to `wandb.log` when wandb is importable and
    `project` (or $WANDB_PROJECT) is set."""

    def __init__(self, log_dir, rank: int = 0, project=None, run_name=None,
                 logger=None):
        super().__init__(log_dir, rank, logger)
        self._buffer = {}
        self._step = 0
        self._wandb = None
        project = project or os.environ.get("WANDB_PROJECT")
        if rank == 0 and project:
            try:
                import wandb
            except ImportError:
                return
            wandb.init(project=project, name=run_name, dir=str(log_dir))
            self._wandb = wandb

    def add_scalar(self, tag, value, step=None):
        if tag in self._buffer:
            self._flush_buffer()
        self._buffer[tag] = (float(value), step)

    def _flush_buffer(self):
        if not self._buffer:
            return
        for tag, (value, step) in self._buffer.items():
            super().add_scalar(tag, value,
                               self._step if step is None else step)
        if self._wandb is not None:
            self._wandb.log({t: v for t, (v, _) in self._buffer.items()})
        self._buffer.clear()
        self._step += 1

    def flush(self):
        self._flush_buffer()
        super().flush()


def augmentation_key(fn):
    """The yaml NAME of one entry of DataAugmentor.queue: the config NAME
    of a method bound with functools.partial, ``gt_sampling`` for the
    DataBaseSampler, else the entry's type name."""
    name = fn.func.__name__ if hasattr(fn, "func") else type(fn).__name__
    if name == "DataBaseSampler":
        return name, "gt_sampling"
    return name, getattr(fn, "keywords", {}).get("config", {}).get(
        "NAME", name)


def disable_augmentation_hook(hook_cfg, dataloader, total_epochs,
                              logger=None):
    """DisableAugmentationHook: an epoch hook that, from epoch
    total_epochs - NUM_LAST_EPOCHS on, drops the augmentations named in
    DISABLE_AUG_LIST from the loader's dataset's augmentor queue."""
    disable_list = list(hook_cfg.get("DISABLE_AUG_LIST", []))
    num_last = int(hook_cfg.get("NUM_LAST_EPOCHS", 5))

    def hook(epoch, loader=None, **kw):
        loader = loader or dataloader
        if epoch < total_epochs - num_last:
            return
        aug = getattr(loader.dataset, "data_augmentor", None)
        if aug is None:
            return
        kept, removed = [], []
        for fn in aug.queue:
            name, key = augmentation_key(fn)
            if key in disable_list or name in disable_list:
                removed.append(key)
            else:
                kept.append(fn)
        if removed and logger:
            logger.info(f"epoch {epoch}: disabled augmentations {removed}")
        aug.queue = kept

    return hook
