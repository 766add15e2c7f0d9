"""Data parallelism over processes — port of
findnpropagate_tpu/parallel/mesh.py:18-66.

The reference runs ONE program over the global batch: every process feeds
its rows, XLA treats the data mesh as one array and inserts the
all-reduces, so everything computed over the batch axis — BatchNorm
statistics, the loss normalisers that count over the batch, the gradient
norm, the logged scalars — is computed over the global batch. Here each
process drives one GPU under DDP (runtime/trainer.py) and holds its own
rows; the batch-axis reductions go through `all_sum`, which sums across
the process group with autograd inside a training step
(`global_batch`) and is the identity otherwise, so the step at world size
W equals the one-process step on the same rows concatenated rank-major.

`make_mesh`, `data_sharding`, `shard_batch`, `make_global_batch` and
`replicated` have no counterpart: DDP replicates the module on every
process and the loader shards the rows (`DataLoader(shard_id,
num_shards)`), so there is no global array to assemble.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

DEFAULT_PORT = "29500"


def slurm_first_node(nodelist: str) -> str:
    """The first host of a SLURM node list: "node[3-5,7]" -> "node3",
    "a,b" -> "a"."""
    if "[" in nodelist:
        prefix, rest = nodelist.split("[", 1)
        return prefix + rest.split("-")[0].split(",")[0].rstrip("]")
    return nodelist.split(",")[0]


def launch_config(env=None, coordinator_address=None, num_processes=None,
                  process_id=None):
    """(address, world size, rank, local rank), resolved as the reference
    resolves them: the explicit arguments; then MASTER_ADDR / MASTER_PORT
    / WORLD_SIZE / RANK (torch.distributed.launch, torchrun) with
    LOCAL_RANK; then SLURM (SLURM_NTASKS > 1, SLURM_PROCID, SLURM_LOCALID,
    the first node of SLURM_NODELIST, port MASTER_PORT or 29500). None
    when none of them is given. A launcher's world size of 1 (torchrun
    --nproc_per_node 1) still gives a group of one process, where the
    reference's bootstrap returns without one."""
    env = os.environ if env is None else env
    local = int(env.get("LOCAL_RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "WORLD_SIZE" in env:
            coordinator_address = (
                f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', DEFAULT_PORT)}")
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env.get("RANK", 0))
        elif "SLURM_NTASKS" in env and int(env["SLURM_NTASKS"]) > 1:
            node = slurm_first_node(env.get("SLURM_NODELIST", "localhost"))
            coordinator_address = (
                f"{node}:{env.get('MASTER_PORT', DEFAULT_PORT)}")
            num_processes = int(env["SLURM_NTASKS"])
            process_id = int(env["SLURM_PROCID"])
            local = int(env.get("SLURM_LOCALID", local))
        else:
            return None
    if num_processes is None or int(num_processes) < 1:
        return None
    return (coordinator_address, int(num_processes), int(process_id or 0),
            local)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None, backend=None):
    """Multi-process bootstrap, the reference's init_dist_pytorch /
    init_dist_slurm: resolves its inputs with `launch_config`, starts the
    default process group over tcp://<address> (NCCL on CUDA, gloo on the
    CPU, or `backend`) and, on CUDA, sets the device of LOCAL_RANK.
    Returns (rank, world size); (0, 1) and nothing started when no
    launcher and no argument names the processes. `device` is "cuda" (the
    default) or "cpu"."""
    conf = launch_config(None, coordinator_address, num_processes,
                         process_id)
    if conf is None:
        return 0, 1
    address, world, rank, local = conf
    on_cuda = torch.device(device or "cuda").type == "cuda"
    if on_cuda:
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend or ("nccl" if on_cuda else "gloo"),
            init_method=f"tcp://{address}", world_size=world, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def rank_and_world():
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_STEP = {"on": False}


@contextlib.contextmanager
def global_batch():
    """The body is one training step over the global batch: `all_sum`
    reduces across the default group while it runs (when that group has
    more than one process)."""
    prev = _STEP["on"]
    _STEP["on"] = rank_and_world()[1] > 1
    try:
        yield
    finally:
        _STEP["on"] = prev


def reducing() -> bool:
    """Whether `all_sum` reduces across processes right now."""
    return _STEP["on"]


def global_rows(n: int):
    """The global batch's size for `n` rows of this process: n times the
    world size inside a `global_batch` step (every process holds as many
    rows: the sharded loader drops the remainder), else n."""
    return n * rank_and_world()[1] if reducing() else n


class _AllSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of every rank's x is the sum
    over ranks of the gradients of y (each rank's loss reads its y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_sum(*tensors):
    """Each tensor summed across the processes of a `global_batch` step in
    one collective, with autograd; the tensors as given otherwise. One
    tensor in, one out; several in, a tuple out."""
    if not reducing():
        return tensors[0] if len(tensors) == 1 else tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if flat.requires_grad:
        flat = _AllSum.apply(flat)
    else:
        flat = flat.clone()
        dist.all_reduce(flat)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out[0] if len(out) == 1 else tuple(out)
