"""The port's training and evaluation CLIs (findnpropagate_torch/tools/
train.py, test.py) on the CPU, on the small nuScenes-layout tree of
tests/test_torch_nuscenes.py, with a narrow copy of
tools/cfgs/nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml (its
model at 16 channels on a 256 x 256 x 40 grid, six head groups, SUBM_IMPL
pallas; known classes car, truck and pedestrian of the tree's five).

train.py trains one epoch of two steps and writes its checkpoint; test.py
evaluates it. The port's `eval_ckpt` is held against the JAX CLI's
(tools/test.py, imported with importlib) on the same weights (the port's
checkpoint through `to_jax_tree`), the JAX detector on its exact XLA
windowed sparse convs (SUBM_IMPL: xla, highest matmul precision). Both
decode the same heatmap logits rounded to 1/64 (a wrapper of each
detector's post_process; the regression maps stay each side's own): float32
sums in another order put near-equal scores of empty cells 1 ulp apart on
one side only, and the top-k would then order them differently.
Tolerances: labels, counts and the recall telemetry's counts exact; boxes
and scores 1e-4 (the detector's outputs through 16 sparse convs, as
tests/test_torch_centerpoint.py); the evaluation's numbers 1e-4
absolute.
"""

import copy
import importlib.util
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from findnpropagate_torch.datasets import build_dataloader as torch_loader
from findnpropagate_torch.datasets import nuscenes_infos as TNI
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.runtime.trainer import (
    latest_checkpoint,
    restore_checkpoint,
)
from findnpropagate_torch.tools import test as test_cli
from findnpropagate_torch.tools import train as train_cli
from findnpropagate_torch.utils.weights import to_jax_tree
from findnpropagate_tpu.config import cfg_from_yaml_file as jax_cfg
from findnpropagate_tpu.datasets import build_dataloader as jax_loader
from findnpropagate_tpu.models import build_network as jax_build
from test_torch_nuscenes import VERSION, dataset_cfg, write_tree

CP_YAML = "tools/cfgs/nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml"
KNOWN = ["car", "truck", "pedestrian"]
STEP = 1 / 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_yaml(root, path):
    """The CenterPoint yaml narrowed, with the tree's DATA_CONFIG: 3
    sweeps, no CBGS (6 train frames: two steps of 3), no shuffling, the
    tree's gt database."""
    with open(CP_YAML) as f:
        cfg = yaml.safe_load(f)
    data = dataset_cfg(root, max_sweeps=3, cbgs=False)
    data.update(POINT_CLOUD_RANGE=[-25.6, -25.6, -5.0, 25.6, 25.6, 3.0])
    data["CAPACITIES"].update(MAX_POINTS=16000, MAX_VOXELS=4096)
    for p in data["DATA_PROCESSOR"]:
        if p["NAME"] == "shuffle_points":
            p["SHUFFLE_ENABLED"] = {"train": False, "test": False}
        if p["NAME"] == "transform_points_to_voxels":
            p["VOXEL_SIZE"] = [0.2, 0.2, 0.2]
    cfg["DATA_CONFIG"] = data
    cfg["KNOWN_CLASS_NAMES"] = KNOWN
    m = cfg["MODEL"]
    m["BACKBONE_3D"].update({
        "MAX_VOXELS": 4096, "LEVEL_CAPACITIES": [4096, 4096, 4096, 2048,
                                                 2048],
        "WINDOWED_BLOCK": 512, "WINDOWED_WINDOW": 4096,
        "WINDOWED_STRIDED_WINDOW": 8192, "CHANNELS": [16, 16, 16, 16, 16],
        "OUT_CHANNELS": 16, "DENSE_DTYPE": "f32"})
    m["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = 32
    m["BACKBONE_2D"].update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                             "NUM_UPSAMPLE_FILTERS": [16, 16]})
    h = m["DENSE_HEAD"]
    h["SHARED_CONV_CHANNEL"] = 16
    h["POST_PROCESSING"].update(MAX_OBJ_PER_SAMPLE=60)
    h["POST_PROCESSING"]["NMS_CONFIG"].update(NMS_PRE_MAXSIZE=120,
                                              NMS_POST_MAXSIZE=40)
    cfg["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"] = 3
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tree, its infos and gt database, the narrow yaml, and the
    checkpoint of `train.py --epochs 1 --device cpu` run in a scratch
    working directory."""
    work = tmp_path_factory.mktemp("cli")
    root = write_tree(work / "raw")
    out = TNI.create_nuscenes_infos(root, version=VERSION, max_sweeps=3)
    TNI.create_groundtruth_database(root, out["train"])
    cfg_path = narrow_yaml(root, work / "cp_narrow.yaml")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc = train_cli.main(["--cfg_file", str(cfg_path), "--epochs", "1",
                             "--seed", "3", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    run = work / "output" / work.name / "cp_narrow" / "default"
    return work, cfg_path, run


def test_train_cli_writes_a_checkpoint_of_two_steps(trained):
    work, cfg_path, run = trained
    ckpt = latest_checkpoint(run / "ckpt")
    assert ckpt is not None and ckpt.name == "checkpoint_1.pt"
    state = torch.load(ckpt, weights_only=True)
    assert state["optimizer"]["count"] == 2
    log = next(run.glob("log_train_*.txt")).read_text()
    assert "epoch 0 it 0/2" in log and "training done" in log
    assert "sparse_window_overflow=0.0000" in log


def test_train_cli_dist_is_refused(trained, monkeypatch):
    """`--dist` under a launcher's world size of 1 (gloo on the CPU)
    starts a group of one, logs it, and trains exactly as without it."""
    import socket

    work, cfg_path, run = trained
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(work)
    assert train_cli.main(["--cfg_file", str(cfg_path), "--epochs", "1",
                           "--seed", "3", "--device", "cpu", "--dist",
                           "--extra_tag", "dist"]) == 0
    assert not torch.distributed.is_initialized()
    dist_run = run.parent / "dist"
    log = next(dist_run.glob("log_train_*.txt")).read_text()
    assert "world size 1 (gloo), batch 3 per process, global batch 3" in log
    got = torch.load(dist_run / "ckpt" / "checkpoint_1.pt", weights_only=True)
    want = torch.load(run / "ckpt" / "checkpoint_1.pt", weights_only=True)
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 2
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k


def rounded_post_process(post_process, round_fn):
    """post_process on heatmap logits rounded to STEP (see the module
    docstring)."""
    def run(out, *a, **kw):
        out = dict(out)
        out["center_preds"] = tuple(
            {k: round_fn(v / STEP) * STEP if k == "hm" else v
             for k, v in p.items()} for p in out["center_preds"])
        return post_process(out, *a, **kw)
    return run


@pytest.fixture(scope="module")
def evaluated(trained):
    """The port's eval_ckpt and the JAX CLI's on the checkpoint's
    weights, and the port's test.py run on it."""
    work, cfg_path, run = trained
    logger = logging.getLogger("test_torch_cli")
    cfg = test_cli.parse_config(["--cfg_file", str(cfg_path)])[1]
    names = list(cfg.CLASS_NAMES)
    ds, loader, _ = torch_loader(cfg.DATA_CONFIG, names, batch_size=2,
                                 training=False)
    det = torch_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=ds,
                      device="cpu")
    restore_checkpoint(latest_checkpoint(run / "ckpt"), det)
    det.post_process = rounded_post_process(det.post_process, torch.round)
    t_annos, t_res = test_cli.eval_ckpt(det, loader, ds, logger, names,
                                        known_classes=KNOWN)

    spec = importlib.util.spec_from_file_location("jax_test_cli",
                                                  "tools/test.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcfg = jax_cfg(str(cfg_path))
    jcfg.MODEL.BACKBONE_3D.SUBM_IMPL = "xla"
    jcfg.MODEL.BACKBONE_3D.WINDOWED_PRECISION = "highest"
    jds, jloader, _ = jax_loader(jcfg.DATA_CONFIG, names, batch_size=2,
                                 training=False, prefetch=0)
    jdet = jax_build(jcfg.MODEL, num_class=10, dataset=jds)
    jdet.post_process = rounded_post_process(jdet.post_process, jnp.round)
    variables = {"params": to_jax_tree(det, "param"),
                 "batch_stats": to_jax_tree(det, "batch_stats")}
    with jax.default_matmul_precision("highest"):
        j_annos, j_res = jcli.eval_ckpt(jdet, jloader, jds, variables,
                                        logger, names, known_classes=KNOWN)

    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc = test_cli.main(["--cfg_file", str(cfg_path), "--batch_size",
                            "2", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    return t_annos, t_res, j_annos, j_res, run


def test_eval_ckpt_detections_match_jax(evaluated):
    t_annos, _, j_annos, _, _ = evaluated
    assert len(t_annos) == len(j_annos) == 3
    for t, j in zip(t_annos, j_annos):
        assert t["frame_id"] == j["frame_id"]
        np.testing.assert_array_equal(t["labels"], j["labels"])
        np.testing.assert_allclose(t["boxes"], j["boxes"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-4,
                                   atol=1e-4)
    assert sum(len(t["labels"]) for t in t_annos) > 0


def test_eval_ckpt_result_matches_jax_with_known_unknown_keys(evaluated):
    _, t_res, _, j_res, run = evaluated
    assert set(t_res) == set(j_res)
    for key in ("AP_B", "AP_N", "AR_N", "NDS", "mAP", "recall_0.3",
                "recall_known_0.3", "recall_unknown_0.3"):
        assert key in t_res, key
    for k, v in j_res.items():
        if isinstance(v, (int, float, np.floating)):
            np.testing.assert_allclose(t_res[k], v, atol=1e-4, err_msg=k)
    got = json.loads((run / "eval" / "result.json").read_text())
    assert set(got) == set(t_res)
    assert np.isfinite(got["NDS"]) and np.isfinite(got["mAP"])


def test_repeat_eval_ckpt_evaluates_each_checkpoint_once(trained, tmp_path):
    """--watch: every checkpoint_<step>.pt once, eval_list.txt and
    result_<ckpt>.json written, until no new one comes."""
    work, cfg_path, run = trained
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    src = latest_checkpoint(run / "ckpt")
    for step in (1, 2):
        (ckpt_dir / f"checkpoint_{step}.pt").write_bytes(src.read_bytes())
    (tmp_path / "eval_list.txt").write_text("checkpoint_1\n")
    cfg = test_cli.parse_config(["--cfg_file", str(cfg_path)])[1]
    ds, loader, _ = torch_loader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES),
                                 batch_size=3, training=False)
    det = torch_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=ds,
                      device="cpu")
    res = test_cli.repeat_eval_ckpt(
        det, loader, ds, logging.getLogger("test_torch_cli"),
        list(cfg.CLASS_NAMES), ckpt_dir, tmp_path, known_classes=KNOWN,
        max_batches=1, max_waiting_mins=0, wait_interval=0)
    assert list(res) == ["checkpoint_2"]
    assert (tmp_path / "eval_list.txt").read_text().split() == [
        "checkpoint_1", "checkpoint_2"]
    assert "recall_known_0.3" in json.loads(
        (tmp_path / "result_checkpoint_2.json").read_text())
