"""Training runtime: train step, eval step, epoch loop, checkpoints — port
of findnpropagate_tpu/runtime/trainer.py (`make_train_step` :66-151,
`make_eval_step` :154, checkpoints :180-255, `train_epochs` :260-366).

The reference threads an explicit TrainState through a jitted step; here
the state lives where PyTorch keeps it — the parameters and BN buffers in
the detector module, the moments and the update count in the `Optimizer`
(runtime/optimization.py) — and a step is eager: forward in training mode,
Hungarian targets, loss, backward, clip, update. Checkpoints go through
`torch.save` as {step, model, optimizer}. Under a profiler the step
records the spans of utils/trace.py: each microbatch's `forward`, `loss`
(the head's Hungarian matching in `assign`) and `backward`, then the
step's `optimizer`, each a root in the batch of the forward before it.

The reference's mesh argument (one program over the batch sharded on a
data mesh) becomes DDP: when a process group of more than one process is
up (parallel/mesh.py::init_distributed), the step runs the detector under
DistributedDataParallel inside `mesh.global_batch()`, where the BN
statistics and the loss normalisers that count over the batch are summed
across the processes, so each process's loss is its share of the global
batch's loss. DDP averages the gradients, so the local loss is scaled by
the world size before the backward, and the logged metrics are the sums
of the shares. Microbatches of gradient accumulation run under `no_sync`
but the last. Process 0 alone writes checkpoints, in the one-process
format; every process ends an epoch at a barrier.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

from ..parallel import mesh
from ..utils import trace


def _split(batch, accum_steps):
    """The batch's leading axis cut into `accum_steps` equal microbatches."""
    out = [{} for _ in range(accum_steps)]
    for k, v in batch.items():
        b = v.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch axis {b} of {k!r} does not divide by "
                             f"accum_steps={accum_steps}")
        for i, part in enumerate(v.reshape(
                accum_steps, b // accum_steps, *v.shape[1:])):
            out[i][k] = part
    return out


class _Loss(torch.nn.Module):
    """The detector's training loss as a module's forward, for DDP (which
    syncs the gradients of what its forward ran)."""

    def __init__(self, detector):
        super().__init__()
        self.detector = detector

    def forward(self, batch, generator):
        return self.detector.loss(batch, generator)


def _ddp(detector, find_unused):
    dev = next(detector.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        _Loss(detector), device_ids=[dev] if dev.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=find_unused)


def make_train_step(detector, tx, seed: int = 17, accum_steps: int = 1):
    """Returns train_step(batch) -> metrics (dict of 0-d tensors: the
    loss's tb entries, ``loss`` and ``grad_norm`` before clipping). The
    step updates `detector` and `tx` in place.

    `seed` drives the dropout masks: one torch.Generator on the detector's
    device, re-seeded from (seed, update count, microbatch, rank) each
    time. accum_steps > 1: gradient accumulation — the batch is split into
    `accum_steps` microbatches run one after the other; gradients and tb
    entries are averaged, the BN statistics chain through the microbatches,
    and the optimizer sees one update of the whole batch, while peak
    activations stay at microbatch size.

    With a process group of W > 1 processes up, `batch` is this process's
    rows and the step is the one-process step over the W processes' rows
    concatenated rank-major (at accum_steps 1; with accumulation each
    global microbatch is every process's microbatch of that index, where
    the reference cuts the concatenated batch into contiguous parts). The
    first step lets DDP look for parameters that take no gradient
    (``train_step.ddp["unused"]`` names them); when it finds none, later
    steps run without the search."""
    dev = next(detector.parameters()).device
    gen = torch.Generator(device=dev)
    rank, world = mesh.rank_and_world()
    ddp = {"module": _ddp(detector, True) if world > 1 else None,
           "searching": world > 1, "unused": []}

    def train_step(batch):
        detector.train()
        tx.zero_grad()
        micro = [batch] if accum_steps <= 1 else _split(batch, accum_steps)
        inv = 1.0 / len(micro)
        wrapped = ddp["module"]
        total, tb_sum = None, {}
        for idx, mb in enumerate(micro):
            gen.manual_seed((seed * 1_000_003 + tx.count) * 4099 + idx
                            + (rank << 48))
            sync = (contextlib.nullcontext() if wrapped is None
                    or idx == len(micro) - 1 else wrapped.no_sync())
            with sync, mesh.global_batch():
                loss, tb = (wrapped or detector.loss)(mb, gen)
                with trace.span("backward"):
                    (loss * (inv * world)).backward()
            total = loss.detach() if total is None else total + loss.detach()
            for k, v in tb.items():
                v = v.detach().float()
                tb_sum[k] = v if k not in tb_sum else tb_sum[k] + v
        metrics = {k: v * inv for k, v in tb_sum.items()}
        metrics["loss"] = total * inv
        if world > 1:
            # every entry is this process's share of the global value
            keys = sorted(metrics)
            flat = torch.stack([metrics[k].reshape(()) for k in keys])
            dist.all_reduce(flat)
            metrics = dict(zip(keys, flat.unbind()))
        if ddp["searching"]:
            ddp["searching"] = False
            ddp["unused"] = [n for n, p in detector.named_parameters()
                             if p.requires_grad and p.grad is None]
            flag = torch.tensor(float(len(ddp["unused"])), device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            if not flag.item():
                ddp["module"] = wrapped = None
                gc.collect()        # the first wrapper's autograd hooks go
                ddp["module"] = _ddp(detector, False)
        with trace.span("optimizer"):
            metrics["grad_norm"] = tx.step()
        return metrics

    train_step.ddp = ddp
    return train_step


def make_eval_step(detector, with_overflow=False):
    """Returns eval_step(batch) -> Detections (with ``with_overflow``:
    (Detections, sparse_window_overflow), 0 without a sparse backbone).
    The forward and post_process run under no_grad with the module in eval
    mode (dropout off, BN on its running statistics), and the module is put
    back in the mode it was in, so a training loop can call it between
    steps."""

    def eval_step(batch):
        was_training = detector.training
        detector.eval()
        try:
            with torch.no_grad():
                out = detector(batch)
                dets = detector.post_process(out)
        finally:
            detector.train(was_training)
        if not with_overflow:
            return dets
        # a detector without a sparse backbone has no window to overflow
        return dets, out.get("sparse_window_overflow", torch.zeros(
            (), dtype=torch.int32, device=dets.count.device))

    return eval_step


# ---------------------------------------------------------------- checkpoints

def _state(detector, tx, step):
    return {"step": int(tx.count if step is None else step),
            "model": detector.state_dict(), "optimizer": tx.state_dict()}


def _step_of(path):
    return int(Path(path).stem.split("_")[-1])


def save_checkpoint(ckpt_dir, detector, tx, step=None, max_keep: int = 5):
    """checkpoint_<step>.pt with {step, model, optimizer}; keeps the newest
    `max_keep`."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    state = _state(detector, tx, step)
    path = ckpt_dir / f"checkpoint_{state['step']}.pt"
    tmp = path.with_suffix(".pt.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    for old in sorted(ckpt_dir.glob("checkpoint_*.pt"),
                      key=_step_of)[:-max_keep]:
        old.unlink(missing_ok=True)
    return path


def latest_checkpoint(ckpt_dir):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    ckpts = sorted(ckpt_dir.glob("checkpoint_*.pt"), key=_step_of)
    return ckpts[-1] if ckpts else None


def save_intra_checkpoint(ckpt_dir, detector, tx, epoch: int, it: int):
    """Timed mid-epoch save: one rotating ``latest_model.pt`` plus a json
    sidecar recording (epoch, it), each written to a temporary name and
    renamed, the sidecar last, so a run killed mid-save keeps its previous
    resume point."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / "latest_model.pt"
    meta = ckpt_dir / "latest_model.meta.json"
    tmp = ckpt_dir / "latest_model.pt.tmp"
    meta_tmp = ckpt_dir / "latest_model.meta.json.tmp"
    torch.save(_state(detector, tx, None), tmp)
    meta_tmp.write_text(json.dumps(
        {"epoch": int(epoch), "it": int(it), "step": int(tx.count)}))
    os.replace(tmp, final)
    os.replace(meta_tmp, meta)
    return final


def latest_intra_checkpoint(ckpt_dir):
    """(path, epoch, it) of the timed mid-epoch save, or None."""
    path = Path(ckpt_dir) / "latest_model.pt"
    meta = Path(ckpt_dir) / "latest_model.meta.json"
    if not meta.exists() or not path.exists():
        return None
    m = json.loads(meta.read_text())
    return path, int(m["epoch"]), int(m["it"])


def restore_checkpoint(path, detector, tx=None):
    """Load a checkpoint into `detector` (and `tx`); returns its step."""
    dev = next(detector.parameters()).device
    state = torch.load(Path(path), map_location=dev, weights_only=True)
    detector.load_state_dict(state["model"])
    if tx is not None:
        tx.load_state_dict(state["optimizer"])
    return int(state["step"])


# ---------------------------------------------------------------- epoch loop

def train_epochs(detector, loader, tx, epochs, logger=None, ckpt_dir=None,
                 log_interval=10, ckpt_save_interval=1, start_epoch=0,
                 hooks=None, writer=None, schedule=None, seed: int = 17,
                 accum_steps: int = 1, ckpt_save_time_interval=None,
                 start_it: int = 0):
    """Epoch loop. `loader` yields dict batches of numpy arrays or
    tensors, has a length, and may have `set_epoch`.

    ckpt_save_time_interval (seconds): timed ``latest_model`` saves inside
    the epoch; resume through latest_intra_checkpoint + start_it, which
    skips the first iterations of start_epoch. Every log interval the
    metrics are read (the step's one blocking read), a nonzero
    ``sparse_window_overflow`` raises a RuntimeWarning, and ``data_time`` /
    ``step_time`` per step are added. Returns the logged history.

    Under a process group (see make_train_step) `loader` yields this
    process's rows, the metrics are the global batch's, process 0 alone
    saves, and every process waits for the others at the end of an epoch."""
    train_step = make_train_step(detector, tx, seed=seed,
                                 accum_steps=accum_steps)
    dev = next(detector.parameters()).device
    rank, world = mesh.rank_and_world()
    emit = (logger.info if logger else print) if rank == 0 \
        else (lambda *a: None)
    if rank:
        ckpt_dir = writer = None
    history = []
    global_it = start_epoch * len(loader) + start_it
    last_timed_save = time.time()
    for epoch in range(start_epoch, epochs):
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        for h in hooks or ():
            h(epoch=epoch, loader=loader)
        t0 = time.time()
        data_time = 0.0
        t_iter = time.time()
        t_last_log = time.time()
        for it, batch in enumerate(loader):
            data_time += time.time() - t_iter
            if epoch == start_epoch and it < start_it:
                t_iter = time.time()
                continue
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
                     if k not in ("frame_id", "batch_size")}
            metrics = train_step(batch)
            if world > 1 and global_it == start_epoch * len(loader) \
                    + start_it:
                emit("DDP over %d processes; parameters without a gradient "
                     "(find_unused_parameters %s): %s" % (
                         world, "on" if train_step.ddp["unused"] else "off",
                         train_step.ddp["unused"] or "none"))
            global_it += 1
            if (ckpt_save_time_interval is not None and ckpt_dir is not None
                    and time.time() - last_timed_save
                    > ckpt_save_time_interval):
                save_intra_checkpoint(ckpt_dir, detector, tx, epoch, it + 1)
                last_timed_save = time.time()
                emit(f"timed checkpoint saved at epoch {epoch} it {it + 1}")
            if it % log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if m.get("sparse_window_overflow", 0) > 0:
                    warnings.warn(
                        "sparse_window_overflow="
                        f"{int(m['sparse_window_overflow'])} — windowed "
                        "sparse conv truncated neighbors; enlarge "
                        "WINDOWED_WINDOW/WINDOWED_STRIDED_WINDOW (results "
                        "are wrong)", RuntimeWarning, stacklevel=1)
                history.append(m)
                steps = max(1, log_interval if it else 1)
                m["data_time"] = data_time / steps
                m["step_time"] = (time.time() - t_last_log) / steps
                data_time = 0.0
                t_last_log = time.time()
                emit(f"epoch {epoch} it {it}/{len(loader)} "
                     + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
                if writer is not None:
                    for k, v in m.items():
                        writer.add_scalar(f"train/{k}", v, global_it)
                    if schedule is not None:
                        writer.add_scalar("meta_data/learning_rate",
                                          float(schedule(global_it)),
                                          global_it)
                if dev.type == "cuda" and it % (3 * log_interval) == 0:
                    used = torch.cuda.memory_allocated(dev) / 2 ** 30
                    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                    emit(f"device mem {used:.2f} GiB (peak {peak:.2f})")
            t_iter = time.time()
        emit(f"epoch {epoch} done in {time.time() - t0:.1f}s")
        if ckpt_dir is not None and (epoch + 1) % ckpt_save_interval == 0:
            save_checkpoint(ckpt_dir, detector, tx, step=epoch + 1)
        if world > 1:
            dist.barrier()
    if writer is not None:
        writer.flush()
    return history
