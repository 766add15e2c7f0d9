"""Data-parallel training of the port (parallel/mesh.py, the DDP step of
runtime/trainer.py) against the one-process step and the JAX step.

The reference's step is one program over the global batch, so the port's
step over two gloo processes, one scene each, must equal its one-process
step over both scenes, and the JAX make_train_step at that batch. The two
scenes of the narrow TransFusion of tests/test_torch_transfusion_train.py
differ in their voxel counts and in their positives (12 ground truths in
one, 5 in the other), so per-process BN statistics or per-process loss
normalisers would not give the same step (`test_per_process_statistics_
would_differ` shows by how much). Dropout 0 on both sides.

Tolerances: against the one-process step 1e-5 (parameters atol, loss and
BN statistics rtol / atol); against JAX those of
test_torch_transfusion_train.py::test_one_train_step_matches_jax.
"""

import contextlib
import copy
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.parallel import mesh
from findnpropagate_torch.runtime.optimization import (
    build_optimizer as torch_build_optimizer,
)
from findnpropagate_torch.runtime.trainer import (
    make_train_step,
    restore_checkpoint,
)
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.runtime.optimization import build_optimizer
from findnpropagate_tpu.runtime.trainer import TrainState
from findnpropagate_tpu.runtime.trainer import (
    make_train_step as jax_make_train_step,
)
from test_torch_transfusion_train import OPT, flat, train_cfg, train_data

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240           # seconds each worker may take
KEEP = (12, 5)          # ground truths kept in the scenes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the launcher

CASES = [
    # (environment, explicit (address, processes, id), resolved)
    ({}, None, None),
    ({"MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "4", "RANK": "3"}, None,
     ("10.0.0.1:29500", 4, 3, 0)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1234", "WORLD_SIZE": "2",
      "RANK": "1", "LOCAL_RANK": "1"}, None, ("h:1234", 2, 1, 1)),
    ({"MASTER_ADDR": "h", "WORLD_SIZE": "2"}, None, ("h:29500", 2, 0, 0)),
    ({"MASTER_ADDR": "h"}, None, None),
    ({"MASTER_ADDR": "h", "WORLD_SIZE": "1", "RANK": "0"}, None,
     ("h:29500", 1, 0, 0)),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0",
      "SLURM_NODELIST": "node[3-5,7]"}, None, ("node3:29500", 4, 2, 0)),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_NODELIST": "a,b",
      "MASTER_PORT": "4000"}, None, ("a:4000", 2, 1, 0)),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "0",
      "SLURM_NODELIST": "gpu[12]"}, None, ("gpu12:29500", 2, 0, 0)),
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, None, None),
    ({"MASTER_ADDR": "m", "WORLD_SIZE": "2", "RANK": "1",
      "SLURM_NTASKS": "8", "SLURM_PROCID": "5"}, None, ("m:29500", 2, 1, 0)),
    ({"MASTER_ADDR": "m", "WORLD_SIZE": "8", "RANK": "1"},
     ("x:1", 2, 0), ("x:1", 2, 0, 0)),
]


@pytest.mark.parametrize("env,explicit,want", CASES)
def test_launch_config_follows_the_reference(env, explicit, want,
                                             monkeypatch):
    """The port's resolution against the table, and against the JAX
    init_distributed's own reading of the same environment (its
    jax.distributed.initialize replaced by a recorder). The port starts a
    group of one where the reference starts none (world size 1)."""
    args = explicit or (None, None, None)
    assert mesh.launch_config(env, *args) == want

    import findnpropagate_tpu.parallel.mesh as jmesh

    for k in [k for k in os.environ
              if k.startswith(("MASTER_", "SLURM_")) or k in (
                  "WORLD_SIZE", "RANK", "LOCAL_RANK")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(jax, "process_index", lambda: seen["process_id"])
    monkeypatch.setattr(jax, "process_count", lambda: seen["num_processes"])
    got = jmesh.init_distributed(*args)
    if want is None or want[1] == 1:
        assert got == (0, 1) and not seen
    else:
        assert (seen["coordinator_address"], seen["num_processes"],
                seen["process_id"]) == want[:3]


def test_single_process_starts_nothing(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert mesh.rank_and_world() == (0, 1)
    x = torch.ones(3, requires_grad=True)
    with mesh.global_batch():
        assert not mesh.reducing()
        assert mesh.all_sum(x) is x


# ---------------------------------------------------------- the DDP step

WORKER = r"""
import pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network
from findnpropagate_torch.parallel.mesh import init_distributed
from findnpropagate_torch.runtime.optimization import build_optimizer
from findnpropagate_torch.runtime.trainer import train_epochs
from findnpropagate_torch.utils.weights import from_jax_variables

rank, port, work, accum = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           int(sys.argv[4]))
with open(work + "/setup.pkl", "rb") as f:
    setup = pickle.load(f)
assert init_distributed("localhost:" + port, 2, rank, device="cpu") == (
    rank, 2)
det = build_network(setup["model"], num_class=10,
                    dataset=SyntheticDataset(setup["data"], setup["classes"],
                                             training=True), device="cpu")
from_jax_variables(setup["variables"], det)
tx, _ = build_optimizer(det.parameters(), setup["opt"], 1000)
rows = setup["rows"][rank]
batch = {{k: v[rows] for k, v in setup["batch"].items()}}
history = train_epochs(det, [batch], tx, 1, ckpt_dir=work + "/ckpt",
                       log_interval=1, accum_steps=accum)
torch.save({{"state": det.state_dict(), "metrics": history[0],
            "count": tx.count}}, work + f"/rank{{rank}}.pt")
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(work, accum):
    """Two gloo processes on a free port; each is killed when it outlives
    TIMEOUT."""
    script = Path(work) / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO)))
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), port, str(work), str(accum)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(Path(work) / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def scenes(n):
    """n training scenes of the narrow TransFusion; scene i keeps the first
    KEEP[i % 2] of its 12 ground truths."""
    data = train_data()
    data["SYNTHETIC"]["NUM_SCENES"] = n
    ds = SyntheticDataset(EDict(data), train_cfg().CLASS_NAMES,
                          training=True)
    batch = ds.batch(range(n))
    for i in range(n):
        batch["gt_boxes"][i, KEEP[i % 2]:] = 0.0
    return data, {k: np.asarray(v) for k, v in batch.items()
                  if k not in ("frame_id", "batch_size")}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The scenes, the JAX variables and the JAX step at batch 2."""
    cfg = train_cfg()
    data, batch = scenes(4)
    jcfg = copy.deepcopy(cfg.MODEL)
    jcfg.BACKBONE_3D["SUBM_IMPL"] = "xla"
    ds, _, _ = build_dataloader(JEDict(data), cfg.CLASS_NAMES, batch_size=2,
                                training=True, prefetch=0)
    jdet = jax_build(jcfg, num_class=10, dataset=ds)
    two = {k: v[:2] for k, v in batch.items()}
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, two))

    tx, _ = build_optimizer(JEDict(OPT), 1000)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(jnp.zeros((), jnp.int32), params,
                       jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       tx.init(params))
    with jax.default_matmul_precision("highest"):
        state, metrics = jax_make_train_step(jdet, tx, donate=False)(
            state, {k: jnp.asarray(v) for k, v in two.items()})
    jref = {"params": flat(jax.tree.map(np.asarray, state.params)),
            "batch_stats": flat(jax.tree.map(np.asarray, state.batch_stats)),
            "metrics": {k: float(v) for k, v in metrics.items()}}
    setup = {"model": cfg.MODEL, "data": EDict(data),
             "classes": cfg.CLASS_NAMES, "variables": variables,
             "opt": OPT, "batch": batch}
    return setup, jref, tmp_path_factory


def one_process(setup, rows, accum=1):
    det = torch_build(copy.deepcopy(setup["model"]), num_class=10,
                      dataset=SyntheticDataset(setup["data"],
                                               setup["classes"],
                                               training=True), device="cpu")
    from_jax_variables(setup["variables"], det)
    tx, _ = torch_build_optimizer(det.parameters(), OPT, 1000)
    batch = {k: torch.from_numpy(v[rows]) for k, v in setup["batch"].items()}
    metrics = make_train_step(det, tx, accum_steps=accum)(batch)
    return det, {k: float(v) for k, v in metrics.items()}


# (accum, each rank's rows, the rows of the equal one-process step): with
# accumulation every global microbatch is the ranks' microbatches of one
# index, (0, 2) then (1, 3), where the reference's would be (0, 1), (2, 3)
DDP_CASES = {"accum1": (1, ([0], [1]), [0, 1]),
             "accum2": (2, ([0, 1], [2, 3]), [0, 2, 1, 3])}


_RUNS = {}


def ddp_result(setup, name):
    """(name, the two ranks' results, the one-process detector and its
    metrics, the work directory) of a DDP_CASES case, run once."""
    if name not in _RUNS:
        s, _, factory = setup
        accum, rows, flat_rows = DDP_CASES[name]
        work = factory.mktemp(f"ddp_{name}")
        with open(work / "setup.pkl", "wb") as f:
            pickle.dump(dict(s, rows=rows), f)
        results = run_workers(work, accum)
        det, metrics = one_process(s, flat_rows, accum)
        _RUNS[name] = (name, results, det, metrics, work)
    return _RUNS[name]


@pytest.fixture(scope="module", params=list(DDP_CASES))
def ddp_run(request, setup):
    return ddp_result(setup, request.param)


def test_ddp_step_equals_the_one_process_step(ddp_run):
    """Parameters and BN buffers within 1e-5 of the one-process step's; an
    entry whose gradient is rounding noise (|g| < 1e-8: the whole of
    dense_head.decoder.norm3.bias, whose true gradient is 0) takes an Adam
    step of arbitrary sign and is held to within two steps."""
    name, results, det, metrics, _ = ddp_run
    want = det.state_dict()
    grads = {k: p.grad for k, p in det.named_parameters()}
    for r, res in enumerate(results):
        assert res["count"] == 1
        for k, v in want.items():
            err = (res["state"][k] - v).abs()
            tol = 1e-5 + 1e-5 * v.abs()
            if grads.get(k) is not None:
                tol = torch.where(grads[k].abs() < 1e-8, 2.1e-4, tol)
            assert (err <= tol).all(), (name, r, k, float(err.max()))
        got = res["metrics"]
        assert set(metrics) <= set(got)
        for k, v in metrics.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} rank {r} {k}")
    # the ranks' states are identical, BN buffers included
    for k, v in results[0]["state"].items():
        assert torch.equal(v, results[1]["state"][k]), k


def test_ddp_step_matches_the_jax_step(setup):
    """At accumulation 1 the two-process step is the JAX step at batch 2
    (tolerances of test_one_train_step_matches_jax). With accumulation the
    reference cuts the global batch into contiguous microbatches and the
    port's DDP does not (DDP_CASES)."""
    _, results, one, metrics, _ = ddp_result(setup, "accum1")
    jref = setup[1]
    det = torch_build(copy.deepcopy(setup[0]["model"]), num_class=10,
                      dataset=SyntheticDataset(setup[0]["data"],
                                               setup[0]["classes"],
                                               training=True), device="cpu")
    det.load_state_dict(results[0]["state"])
    np.testing.assert_allclose(results[0]["metrics"]["loss"],
                               jref["metrics"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(results[0]["metrics"]["grad_norm"],
                               jref["metrics"]["grad_norm"], rtol=1e-3)
    for k in ("loss_heatmap", "loss_cls", "loss_bbox", "matched_ious"):
        np.testing.assert_allclose(results[0]["metrics"][k],
                                   jref["metrics"][k], rtol=1e-4, err_msg=k)
    got = flat(to_jax_tree(det, "param"))
    start = flat(setup[0]["variables"]["params"])
    # Adam's first step moves an entry by lr * c g / (|c g| + 1e-8), c the
    # clip factor, so the JAX step's own move tells where its gradient is
    # below 1e-8. An entry whose gradient is below 1e-8 on either side, or
    # below 1e-5 of its leaf's largest on the port's, is rounding noise (a
    # true zero, as the whole of dense_head/decoder/norm3/bias, or a sum of
    # ~1e4 f32 terms that nearly cancel) and is held to within two steps,
    # as in test_one_train_step_matches_jax
    c = min(1.0, OPT["GRAD_NORM_CLIP"] / jref["metrics"]["grad_norm"])
    c_port = min(1.0, OPT["GRAD_NORM_CLIP"] / metrics["grad_norm"])
    port_grads = flat(to_jax_tree(one, "grad"))
    n_off = 0
    for path, w in jref["params"].items():
        err = np.abs(got[path] - w)
        g = np.abs(port_grads[path]) / c_port
        noise = ((np.abs(w - start[path]) / OPT["LR"] < c / (1 + c))
                 | (g < max(1e-8, 1e-5 * float(g.max()))))
        assert (err <= np.where(noise, 2.1e-4, 2e-6)).all(), \
            ("/".join(path), float(err.max()))
        n_off += int((err > 2e-6).sum())
    assert n_off <= 40, n_off
    got_bs = flat(to_jax_tree(det, "batch_stats"))
    for path, w in jref["batch_stats"].items():
        np.testing.assert_allclose(got_bs[path], w, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))


def test_only_rank_zero_writes_a_readable_checkpoint(setup, ddp_run):
    name, results, _, _, work = ddp_run
    ckpts = sorted((work / "ckpt").glob("*"))
    assert [p.name for p in ckpts] == ["checkpoint_1.pt"]
    state = torch.load(ckpts[0], weights_only=True)
    assert not any(k.startswith("module.") for k in state["model"])
    det = torch_build(copy.deepcopy(setup[0]["model"]), num_class=10,
                      dataset=SyntheticDataset(setup[0]["data"],
                                               setup[0]["classes"],
                                               training=True), device="cpu")
    tx, _ = torch_build_optimizer(det.parameters(), OPT, 1000)
    assert restore_checkpoint(ckpts[0], det, tx) == 1 and tx.count == 1
    for k, v in det.state_dict().items():
        assert torch.equal(v, results[0]["state"][k]), k


def test_per_process_statistics_would_differ(setup):
    """The test's scenes tell a plain DDP apart: the mean of the two
    one-scene steps' losses and BN statistics (per-process BN, per-process
    normalisers) is off the batch-2 step's by far more than 1e-5."""
    s = setup[0]
    data = s["data"]
    lo = np.asarray(data["POINT_CLOUD_RANGE"][:3], np.float32)
    size = np.asarray(data["DATA_PROCESSOR"][-1]["VOXEL_SIZE"], np.float32)
    voxels = [len(np.unique(np.floor(
        (s["batch"]["points"][i][s["batch"]["points_mask"][i], :3] - lo)
        / size), axis=0)) for i in (0, 1)]
    assert voxels[0] != voxels[1], voxels
    assert [int((s["batch"]["gt_boxes"][i, :, -1] > 0).sum())
            for i in (0, 1)] == list(KEEP)
    det, both = one_process(s, [0, 1])
    singles = [one_process(s, [i]) for i in (0, 1)]
    assert abs(np.mean([m["loss"] for _, m in singles]) - both["loss"]) \
        > 1e-3 * abs(both["loss"])
    # the running statistics move by 1 - 0.99 of the batch's
    bs = [flat(to_jax_tree(d, "batch_stats")) for d, _ in singles]
    want = flat(to_jax_tree(det, "batch_stats"))
    worst = max(float(np.abs((bs[0][p] + bs[1][p]) / 2 - w).max())
                for p, w in want.items())
    assert worst > 2e-5, worst
    # the gradient a plain DDP would average, against the batch's
    gs = [flat(to_jax_tree(d, "grad")) for d, _ in singles]
    g = flat(to_jax_tree(det, "grad"))
    rel = max(float(np.abs((gs[0][p] + gs[1][p]) / 2 - w).max())
              / max(float(np.abs(w).max()), 1e-12) for p, w in g.items())
    assert rel > 0.1, rel


# ----------------------------------------- every head's global normalisers

@contextlib.contextmanager
def two_identical_ranks(monkeypatch):
    """A training step as two processes holding the same rows see it:
    every collective doubles its tensor. The global batch is then the
    rows twice over, so BN statistics are unchanged and each process's
    loss is half the one-process loss, term by term; a normaliser left
    local would leave its term whole."""
    monkeypatch.setattr(mesh.dist, "all_reduce",
                        lambda t, *a, **k: t.mul_(2))
    monkeypatch.setattr(mesh, "rank_and_world", lambda: (0, 2))
    with mesh.global_batch():
        assert mesh.reducing()
        yield


def t(x):
    return torch.from_numpy(np.asarray(x))


def centernet_case(rng):
    from findnpropagate_torch.utils import losses as L

    pred = t(rng.uniform(0.01, 0.99, (2, 3, 8, 8)).astype(np.float32))
    tgt = rng.uniform(0, 0.9, (2, 3, 8, 8)).astype(np.float32)
    tgt[0, 1, 2, 3] = tgt[1, 0, 5, 5] = tgt[1, 2, 1, 1] = 1.0
    regr = t(rng.randn(2, 6, 4).astype(np.float32))
    gt = t(rng.randn(2, 6, 4).astype(np.float32))
    mask = t(rng.uniform(size=(2, 6)) > 0.4)

    def run():
        hm = L.focal_loss_centernet(pred, t(tgt))
        reg = L.reg_loss_centernet(regr, gt, mask)
        return hm + reg.sum(), {"hm": hm, "reg": reg.sum()}
    return run


def point_case(name):
    from findnpropagate_torch.models.dense_heads import (
        point_head_box,
        point_head_simple,
        point_intra_part_head,
    )
    from test_torch_point_heads import head_cfg, head_inputs

    out = head_inputs(3)[1]
    rng = np.random.RandomState(4)
    b, p = out["point_coords"].shape[:2]
    out.update({"point_cls_preds": t(rng.randn(b, p, 3).astype(np.float32)),
                "point_cls_logits": t(rng.randn(b, p, 1).astype(np.float32)),
                "point_part_preds": t(rng.randn(b, p, 3).astype(np.float32)),
                "point_box_preds_enc": t(rng.randn(b, p, 8).astype(
                    np.float32))})
    cfg = head_cfg()
    if name == "point_box":
        out["point_cls_preds"] = out["point_cls_preds"][..., :1]
        return lambda: point_head_box.point_head_box_loss(out, cfg)
    if name == "point_part":
        return lambda: point_intra_part_head.point_part_head_loss(out, cfg, 3)
    return lambda: point_head_simple.point_head_loss(
        out, {"LOSS_WEIGHTS": {"point_cls_weight": 1.0}})


def rcnn_case(rng, iou):
    from findnpropagate_torch.models.roi_heads import roi_head_template
    from findnpropagate_torch.models.roi_heads import second_head

    b, m = 2, 16
    rois = rng.randn(b, m, 7).astype(np.float32)
    rois[..., 3:6] = np.abs(rois[..., 3:6]) + 1
    gt = rois + 0.1 * rng.randn(b, m, 7).astype(np.float32)
    labels = rng.choice([-1.0, 0.0, 0.4, 1.0], (b, m)).astype(np.float32)
    out = {"rois": t(rois), "rcnn_cls": t(rng.randn(b * m, 1).astype(
        np.float32)), "rcnn_reg": t(0.1 * rng.randn(b, m, 7).astype(
            np.float32)), "rcnn_iou": t(rng.randn(b * m, 1).astype(
                np.float32)),
        "rcnn_targets": {"rcnn_cls_labels": t(labels),
                         "gt_of_rois": t(np.concatenate(
                             [gt, np.ones((b, m, 1), np.float32)], -1)),
                         "gt_of_rois_src": t(gt),
                         "reg_valid_mask": t(rng.uniform(size=(b, m))
                                             > 0.5)}}
    cfg = {"LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                            "rcnn_corner_weight": 1.0,
                            "rcnn_iou_weight": 1.0,
                            "code_weights": [1.0] * 7},
           "CORNER_LOSS_REGULARIZATION": True}
    if iou:
        return lambda: second_head.rcnn_iou_loss(out, cfg)
    return lambda: roi_head_template.two_stage_rcnn_loss(out, cfg)


def anchor_case(rng):
    from findnpropagate_torch.models.dense_heads.anchor_head import (
        make_anchor_head_tools,
    )
    from test_torch_anchor_heads import GRID, PCR, head_cfg

    tools = make_anchor_head_tools(JEDict(copy.deepcopy(head_cfg())), 3,
                                   GRID, PCR)
    n = tools.anchors.shape[0]
    labels = rng.choice([-1, 0, 0, 0, 1, 2, 3], (2, n)).astype(np.int32)
    targets = {"box_cls_labels": t(labels),
               "box_reg_targets": t(0.1 * rng.randn(2, n, 7).astype(
                   np.float32)),
               "reg_weights": t((labels > 0).astype(np.float32))}
    out = {"cls_preds": t(rng.randn(2, n, 3).astype(np.float32)),
           "box_preds": t(0.1 * rng.randn(2, n, 7).astype(np.float32)),
           "dir_cls_preds": t(rng.randn(2, n, 2).astype(np.float32))}
    return lambda: tools.loss(out, targets)


def transfusion_case(setup):
    s = setup[0]
    det = torch_build(copy.deepcopy(s["model"]), num_class=10,
                      dataset=SyntheticDataset(s["data"], s["classes"],
                                               training=True), device="cpu")
    from_jax_variables(s["variables"], det)
    det.train()
    batch = {k: torch.from_numpy(v[:2]) for k, v in s["batch"].items()}

    def run():
        with torch.no_grad():
            return det.loss(batch, torch.Generator().manual_seed(0))
    return run


SHARE_CASES = ["centernet", "point_box", "point_part", "point_simple",
               "rcnn", "rcnn_iou", "anchor", "transfusion"]


@pytest.mark.parametrize("name", SHARE_CASES)
def test_every_normaliser_counts_over_the_global_batch(name, setup,
                                                       monkeypatch):
    """Each head's loss (and each of its tb entries) under two processes
    holding the same rows is half the one-process value; counts stay
    whole (each process reports its own)."""
    rng = np.random.RandomState(0)
    run = {"centernet": lambda: centernet_case(rng),
           "rcnn": lambda: rcnn_case(rng, False),
           "rcnn_iou": lambda: rcnn_case(rng, True),
           "anchor": lambda: anchor_case(rng),
           "transfusion": lambda: transfusion_case(setup)}.get(
               name, lambda: point_case(name))()
    loss, tb = run()
    with two_identical_ranks(monkeypatch):
        share, tb_share = run()
    np.testing.assert_allclose(float(share), float(loss) / 2, rtol=1e-6)
    assert set(tb) == set(tb_share)
    for k, v in tb.items():
        whole = k.endswith(("_matches", "_num", "sparse_window_overflow"))
        np.testing.assert_allclose(float(tb_share[k]),
                                   float(v) / (1 if whole else 2),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
