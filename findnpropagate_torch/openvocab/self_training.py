"""Self-training orchestration ("Propagate") — port of
findnpropagate_tpu/openvocab/self_training.py.

Per epoch, once past `st_warmup` and on every `st_interval`, the current
model runs over the augmentation-stripped train split and its detections
are saved as per-frame pseudo labels (PseudoProcessor.save_predictions);
the training epochs then read them through the PseudoLoader augmentation
hooks, and the head merges them with the ground truth (its
``merge_pseudos``) with the unknown classes down-weighted.

The extraction can relabel each frame's boxes with a VLM first:
`build_relabeler` is the reference's CLIP_TYPE dispatch (GLIP, CLIP crops,
MaskCLIP; openvocab/box_classification.py) and returns the callable
(boxes, batch, i, labels, scores) -> (labels, scores) that
`extract_pseudo_labels` and `train_model_st` take as `relabeler`.

The state lives in the detector module and the Optimizer, as in
runtime/trainer.py. With a process group of W > 1 processes up
(parallel/mesh.py::init_distributed; `tools/train_st.py --dist`) the
reference's `mesh` argument becomes DDP, as in `tools/train.py --dist`:

  * training: each process's loader holds its shard, B / W rows of the
    global batch of B (the reference's train_st loads B in one process and
    shards it over the mesh), and the step is runtime/trainer.py's DDP step
    over the global batch;
  * extraction, which the reference runs in one process: each process
    runs the eval step over its shard of the augmentation-stripped loader
    (`order[rank::W]` at B / W rows, the last short batch dropped, so the
    processes together save the frames one process saves at batch B) and
    writes its frames' files into the store; the `relabeler` runs in each
    process for its own frames, on the device it was built for. After a
    barrier process 0 alone stamps the epoch, and a second barrier ends
    the extraction before any training loader reads the store. Whether an
    epoch's labels exist is read by every process after the epoch's first
    barrier and agreed on, so that no process re-extracts alone after a
    restart;
  * the pseudo loaders' state (PseudoSampler's copy-paste queues and
    seen-count EMA, PseudoLoader's per-class score EMA) lives in each
    process and sees only that process's rows, where the reference's one
    process sees all of them (ROADMAP.md section 3, PR 21);
  * process 0 alone logs and writes checkpoints; every process ends an
    epoch at a barrier.
"""

from __future__ import annotations

import time
from functools import partial

import torch
import torch.distributed as dist

from .. import resolve_device
from ..parallel import mesh
from ..runtime import trainer
from .pseudo_labels import PseudoLoader, PseudoProcessor


def register_pseudo_hooks(loader: PseudoLoader):
    """The reference's augmentation hook names bound to a PseudoLoader, as
    the mapping name -> factory(cfg, augmentor) that build_dataloader hands
    to the dataset (`hooks=`). The copy-paste step draws from the
    augmentor's rng, the dataset's own."""
    return {
        "load_frustum_pseudos": lambda cfg, aug: loader.load_frustum_pseudos,
        "load_selftrain_pseudos":
            lambda cfg, aug: loader.load_selftrain_pseudos,
        "unknowns_copy_paste":
            lambda cfg, aug: partial(loader.unknowns_copy_paste, rng=aug.rng),
    }


def build_relabeler(opt_cfg, class_names, detector2d=None,
                    image_provider=None, device=None):
    """The VLM relabeler of OPTIMIZATION's CLIP_UNK_RELABEL / CLIP_TYPE:
    GLIP -> GLIPBoxClassification over `detector2d.infer` of the frame's
    `camera_paths`, CROP (the default) -> CLIPBoxClassification, MASKCLIP
    -> CLIPBoxClassificationMaskCLIP over `image_provider(batch, i)`'s
    (NCAM, H, W, 3) images in [0, 1]; both read the batch's `lidar2image`.

    Returns None when relabeling is off, else a callable (boxes, batch, i,
    labels, scores) -> (labels, scores) as numpy arrays, computed on
    `device` (CUDA unless another device is named). It hands back the
    labels and scores unchanged when it has no detector2d (GLIP) or no
    image_provider (CROP, MASKCLIP). Its `vlm` attribute is the
    relabeling object, whose encoders a caller may set."""
    if not opt_cfg.get("CLIP_UNK_RELABEL", False):
        return None
    from .box_classification import (
        CLIPBoxClassification,
        CLIPBoxClassificationMaskCLIP,
        GLIPBoxClassification,
    )

    dev = resolve_device(device)
    clip_type = str(opt_cfg.get("CLIP_TYPE", "CROP")).upper()

    def on_dev(x):
        # floats as f32, as the reference's jnp arrays
        t = torch.as_tensor(x)
        return (t.float() if t.is_floating_point() else t).to(dev)

    if clip_type == "GLIP":
        vlm = GLIPBoxClassification(num_classes=len(class_names))

        def relabel(boxes, batch, i, labels, scores):
            if detector2d is None:
                return labels, scores
            paths = batch.get("camera_paths")
            dets = detector2d.infer(paths[i] if paths is not None else [])
            lab, sc = vlm.relabel(
                on_dev(boxes[:, :7]), on_dev(batch["lidar2image"][i]),
                *[on_dev(dets[k]) for k in ("det_boxes", "det_labels",
                                             "det_scores", "det_cams",
                                             "det_mask")])
            return lab.cpu().numpy(), sc.cpu().numpy()
    else:
        cls = CLIPBoxClassification if clip_type == "CROP" \
            else CLIPBoxClassificationMaskCLIP
        vlm = cls(class_names=class_names)

        def relabel(boxes, batch, i, labels, scores):
            if image_provider is None:
                return labels, scores
            lab, sc = vlm.relabel(
                on_dev(boxes[:, :7]), on_dev(batch["lidar2image"][i]),
                on_dev(image_provider(batch, i)))
            return lab.cpu().numpy(), sc.cpu().numpy()

    relabel.vlm = vlm
    return relabel


def pseudo_labels_exist(processor: PseudoProcessor, epoch: int) -> bool:
    """Epoch-stamp check preventing re-extraction after a restart."""
    return (processor.store is not None
            and processor.store.stamped_epoch() == epoch)


HOST_KEYS = ("frame_id", "batch_size", "camera_paths")


def to_device(batch, device):
    """The batch's arrays as tensors on `device`, one copy each; the
    host-only keys (frame ids, the batch size, the cameras' image names)
    dropped."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if k not in HOST_KEYS}


def extract_pseudo_labels(detector, inference_loader, processor, epoch,
                          logger=None, relabeler=None, max_batches=None,
                          stamp=True):
    """Run the model over the train split in eval mode and save its
    detections as pseudo labels, then (with `stamp`) stamp the store with
    `epoch`; returns the number of frames."""
    eval_step = trainer.make_eval_step(detector)
    dev = next(detector.parameters()).device
    emit = logger.info if logger else print
    t0 = time.time()
    n = 0
    for bi, batch in enumerate(inference_loader):
        if max_batches is not None and bi >= max_batches:
            break
        frame_ids = batch["frame_id"]
        dets = eval_step(to_device(batch, dev))
        boxes = dets.boxes.cpu().numpy()
        scores = dets.scores.cpu().numpy()
        labels = dets.labels.cpu().numpy()
        counts = dets.count.cpu().numpy()
        data_dicts = []
        det_dicts = []
        for i in range(boxes.shape[0]):
            k = int(counts[i])
            b, s, l = boxes[i, :k], scores[i, :k], labels[i, :k]
            if relabeler is not None and k > 0:
                l, s = relabeler(b, batch, i, l, s)
            det_dicts.append(
                {"pred_boxes": b, "pred_scores": s, "pred_labels": l})
            data_dicts.append({"frame_id": frame_ids[i]})
            n += 1
        processor.save_predictions(data_dicts, det_dicts)
    if stamp:
        processor.stamp_epoch(epoch)
    emit(f"extracted pseudo labels for {n} frames in {time.time()-t0:.1f}s")
    return n


def _agreed(flag, device):
    """`flag` of this process, true in every process when true in any
    (identity without a process group)."""
    if mesh.rank_and_world()[1] == 1:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def extract_epoch(detector, inference_loader, processor, epoch, logger=None,
                  relabeler=None):
    """An extraction epoch: unless the store is stamped with `epoch`
    already, every process extracts its shard of `inference_loader`, and
    process 0 stamps the store between two barriers. Returns the frames
    extracted by all processes (0 when the labels existed)."""
    rank, world = mesh.rank_and_world()
    dev = next(detector.parameters()).device
    if world > 1:
        dist.barrier()
    # read after the barrier and agreed on: a process that sees no stamp
    # makes all extract
    if not _agreed(not pseudo_labels_exist(processor, epoch), dev):
        return 0
    n = extract_pseudo_labels(detector, inference_loader, processor, epoch,
                              logger=logger, relabeler=relabeler,
                              stamp=world == 1)
    if world == 1:
        return n
    total = torch.tensor([float(n)], device=dev)
    dist.all_reduce(total)
    dist.barrier()
    if rank == 0:
        processor.stamp_epoch(epoch)
        (logger.info if logger else print)(
            f"extracted pseudo labels for {int(total.item())} frames over "
            f"{world} processes; epoch {epoch} stamped by process 0")
    dist.barrier()
    return int(total.item())


def train_model_st(detector, train_loader, inference_loader, tx, epochs,
                   processor: PseudoProcessor, logger=None, ckpt_dir=None,
                   st_warmup=3, st_interval=1, relabeler=None,
                   log_interval=10, seed: int = 17,
                   ckpt_save_time_interval=None):
    """The self-training epoch driver. ckpt_save_time_interval (seconds):
    timed ``latest_model`` saves inside the epochs. Returns the logged
    history: per logged step the metrics, its epoch and iteration, and the
    seconds spent waiting for the batch (``data_time``). Under a process
    group `train_loader` and `inference_loader` yield this process's
    shards (module docstring); process 0 logs and saves."""
    train_step = trainer.make_train_step(detector, tx, seed=seed)
    dev = next(detector.parameters()).device
    rank, world = mesh.rank_and_world()
    emit = (logger.info if logger else print) if rank == 0 \
        else (lambda *a: None)
    if rank:
        ckpt_dir = None
    history = []
    last_timed_save = time.time()
    for epoch in range(epochs):
        if epoch >= st_warmup and (epoch - st_warmup) % st_interval == 0:
            extract_epoch(detector, inference_loader, processor, epoch,
                          logger=logger, relabeler=relabeler)
        train_loader.set_epoch(epoch)
        t0 = time.time()
        t_iter = time.time()
        for it, batch in enumerate(train_loader):
            data_time = time.time() - t_iter
            metrics = train_step(to_device(batch, dev))
            if (ckpt_save_time_interval is not None and ckpt_dir is not None
                    and time.time() - last_timed_save
                    > ckpt_save_time_interval):
                trainer.save_intra_checkpoint(ckpt_dir, detector, tx, epoch,
                                              it + 1)
                last_timed_save = time.time()
                emit(f"timed checkpoint saved at st epoch {epoch} it {it+1}")
            if it % log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                emit(f"st epoch {epoch} it {it}/{len(train_loader)} "
                     + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
                history.append({"epoch": epoch, "it": it,
                                "data_time": data_time, **m})
            t_iter = time.time()
        emit(f"st epoch {epoch} done in {time.time()-t0:.1f}s")
        if ckpt_dir is not None:
            trainer.save_checkpoint(ckpt_dir, detector, tx, step=epoch + 1)
        if world > 1:
            dist.barrier()
    return history
