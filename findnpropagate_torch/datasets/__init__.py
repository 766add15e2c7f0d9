"""Dataset layer — port of findnpropagate_tpu/datasets/__init__.py.

Host side stays numpy (augmentation, filtering, padding); voxelization runs
on the device inside the model. The loader is a plain python iterator over
fixed-shape numpy batches. DATASET_REGISTRY holds every dataset of the
JAX package: Synthetic, KITTI, nuScenes, Waymo (single- and multi-frame),
ONCE, Lyft, Custom, Argo2 and Pandaset.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .kitti import KittiDataset
from .misc_datasets import (
    Argo2Dataset,
    CustomDataset,
    LyftDataset,
    PandasetDataset,
)
from .nuscenes import NuScenesDataset
from .once import ONCEDataset
from .synthetic import SyntheticDataset
from .waymo import WaymoDataset

DATASET_REGISTRY = {
    "SyntheticDataset": SyntheticDataset,
    "KittiDataset": KittiDataset,
    "NuScenesDataset": NuScenesDataset,
    "WaymoDataset": WaymoDataset,
    "ONCEDataset": ONCEDataset,
    "LyftDataset": LyftDataset,
    "CustomDataset": CustomDataset,
    "Argo2Dataset": Argo2Dataset,
    "PandasetDataset": PandasetDataset,
}


class DataLoader:
    """Deterministic epoch-based loader with per-epoch shuffling and
    fixed-shape batch collation: the order of epoch e is
    ``RandomState(seed + e).permutation`` when shuffling, then every
    `num_shards`-th sample from `shard_id` (the reference's distributed
    sampler), and the last short batch is dropped when `drop_last`."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 shard_id=0, num_shards=1, drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        order = order[self.shard_id :: self.num_shards]
        nb = len(self)
        for b in range(nb):
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            if len(idxs) == 0:
                break
            samples = [self.dataset[int(i)] for i in idxs]
            yield self.dataset.collate_batch(samples)


class PrefetchLoader:
    """Background-thread prefetcher over a DataLoader, so that the host's
    augmentation and collation overlap the device's work: one daemon thread
    fills a bounded queue, and an error in it is raised to the consumer.
    The samples (and every random draw of the dataset) are made in that
    thread only; when the consumer stops early, the thread is stopped and
    joined before the generator returns."""

    def __init__(self, loader: "DataLoader", prefetch: int = 2):
        self.loader = loader
        self.prefetch = int(prefetch)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err = []

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if not put(item):
                        return
            except BaseException as e:  # surface worker errors to consumer
                err.append(e)
            put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join()


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False,
                     training=True, seed=0, logger=None, shard_id=0,
                     num_shards=1, prefetch=2, hooks=None, **kwargs):
    """(dataset, loader, None). The dataset draws from a RandomState(seed)
    of its own; `hooks` (name -> factory(cfg, augmentor)) supply the
    augmentation steps DataAugmentor does not define, such as the
    pseudo-label steps of openvocab/self_training.py::
    register_pseudo_hooks."""
    dataset = DATASET_REGISTRY[dataset_cfg["DATASET"]](
        dataset_cfg=dataset_cfg,
        class_names=class_names,
        training=training,
        logger=logger,
        rng=np.random.RandomState(seed),
        hooks=hooks,
    )
    loader = DataLoader(
        dataset, batch_size, shuffle=training, seed=seed,
        shard_id=shard_id, num_shards=num_shards, drop_last=training,
    )
    if prefetch and prefetch > 0:
        loader = PrefetchLoader(loader, prefetch=prefetch)
    return dataset, loader, None
