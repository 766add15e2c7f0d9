"""The port's spans (findnpropagate_torch/utils/trace.py) on the CPU.

With no profiler a span is one shared no-op object and a forward + decode
records nothing, enters no profiler range and makes no CUDA event. Under
torch.profiler a narrow TransFusion-L (posgather mode, the yaml's levels)
records the span tree of the stages, the sparse backbone and the kernel
wrappers: each span under its parent, `forward` and `decode` in one
batch, K1 six and K2 sixteen times a forward, and every span a named
event of the profile. A training step records forward, loss (with the
Hungarian `assign`), backward and optimizer, each in the step's batch.
`self_ms` is checked on a synthetic tree, `reset` on its records.
"""

import copy
import time

import pytest
import torch

from findnpropagate_torch.config import EDict, cfg_from_yaml_file
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network
from findnpropagate_torch.runtime.optimization import build_optimizer
from findnpropagate_torch.runtime.trainer import make_train_step
from findnpropagate_torch.utils import trace
from findnpropagate_torch.utils.weights import init_random_

B = 2
DATA = {
    "DATASET": "SyntheticDataset",
    "POINT_CLOUD_RANGE": [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0],
    "SYNTHETIC": {"NUM_SCENES": B, "NUM_OBJECTS": 12,
                  "NUM_RAW_POINTS": 60000, "PATTERN": "lidar_ring"},
    "CAPACITIES": {"MAX_POINTS": 20000, "MAX_GT": 64, "MAX_VOXELS": 2048,
                   "MAX_POINTS_PER_VOXEL": 10},
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"]},
    "DATA_PROCESSOR": [
        {"NAME": "mask_points_and_boxes_outside_range",
         "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "shuffle_points",
         "SHUFFLE_ENABLED": {"train": False, "test": False}},
        {"NAME": "transform_points_to_voxels",
         "VOXEL_SIZE": [0.2, 0.2, 0.2]}],
}
# span -> its parent in an inference forward + decode of TransFusion-L
PARENTS = {"forward": None, "voxelize": "forward", "backbone_3d": "forward",
           "map_to_bev": "forward", "backbone_2d": "forward",
           "dense_head": "forward", "active_set": "backbone_3d",
           "positions": "backbone_3d", "posgather_conv": "backbone_3d",
           "dense_conv": "backbone_3d", "dense_epilogue": "dense_conv",
           "decode": None}
# K1 and K2 launches of a forward at the yaml's levels (PERF.md's table),
# and the dense levels' epilogue, one a dense conv
CALLS = {"positions": 6, "posgather_conv": 16, "dense_epilogue": 5,
         "forward": 1, "decode": 1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_model_cfg():
    cfg = cfg_from_yaml_file(
        "tools/cfgs/nuscenes_models/transfusion_lidar.yaml")
    m = cfg.MODEL
    assert m.BACKBONE_3D["SUBM_IMPL"] == "posgather"
    m.BACKBONE_3D.update({
        "MAX_VOXELS": 2048, "LEVEL_CAPACITIES": [2048, 2048, 2048, 1024, 1024],
        "WINDOWED_BLOCK": 512, "CHANNELS": [16, 16, 16, 16, 16],
        "OUT_CHANNELS": 16, "DENSE_DTYPE": "f32"})
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                          "NUM_UPSAMPLE_FILTERS": [16, 16]})
    m.DENSE_HEAD.update({"HIDDEN_CHANNEL": 32, "NUM_HEADS": 2,
                         "FFN_CHANNEL": 64, "NUM_PROPOSALS": 20,
                         "DROPOUT": 0.0})
    return cfg


@pytest.fixture(scope="module")
def narrow():
    """(cfg, dataset, detector in eval mode, batch of B scenes)."""
    cfg = narrow_model_cfg()
    ds = SyntheticDataset(EDict(copy.deepcopy(DATA)), cfg.CLASS_NAMES,
                          training=True)
    det = build_network(copy.deepcopy(cfg.MODEL), num_class=10, dataset=ds,
                        device="cpu")
    init_random_(det, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch(range(B)).items()
             if k in ("points", "points_mask", "gt_boxes")}
    return cfg, ds, det.eval(), batch


def infer(det, batch):
    with torch.no_grad():
        return det.post_process(det(batch))


def profiled(fn):
    """fn() under torch.profiler, with the spans reset first: the
    profiler."""
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_off_a_span_is_one_shared_object_and_records_nothing(
        narrow, monkeypatch):
    _, _, det, batch = narrow
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("forward", scans=batch["points"]) is trace.OFF
    assert trace.span("decode") is trace.span("positions")
    made = []

    def counting(*a, **k):
        made.append(a)
        raise AssertionError("entered with no profiler")

    monkeypatch.setattr(trace, "_Range", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "Event", counting)
    monkeypatch.setattr(trace, "_HostEvent", counting)
    trace.reset()
    dets = infer(det, batch)
    assert int(dets.count.sum()) > 0
    assert made == []
    assert trace.records() == []
    assert trace.totals() == {"spans": {}, "scans": 0, "batches": 0}


def test_profiled_forward_and_decode_give_the_span_tree(narrow):
    _, _, det, batch = narrow
    prof = profiled(lambda: [infer(det, batch) for _ in range(2)])
    recs = trace.records()
    assert {r["name"] for r in recs} == set(PARENTS)
    for r in recs:
        assert r["parent"] == PARENTS[r["name"]], r
    # two batches: each forward a root with its scans, its decode after it
    roots = [(r["name"], r["batch"], r["scans"]) for r in recs
             if r["parent"] is None]
    assert roots == [("forward", 0, B), ("decode", 0, None),
                     ("forward", 1, B), ("decode", 1, None)]
    half = len(recs) // 2
    assert [r["batch"] for r in recs] == [0] * half + [1] * half
    tot = trace.totals()
    assert tot["scans"] == 2 * B and tot["batches"] == 2
    for name, n in CALLS.items():
        assert tot["spans"][name]["calls"] == 2 * n, name
    # the entry's sort and three strided levels; the dense tail's four
    # submanifold convs and its output conv
    assert tot["spans"]["active_set"]["calls"] == 2 * 4
    assert tot["spans"]["dense_conv"]["calls"] == 2 * 5
    for name, t in tot["spans"].items():
        assert t["device_ms"] > 0 and t["host_ms"] > 0, name
        assert t["self_ms"] <= t["device_ms"] + 1e-9, name
    bb = tot["spans"]["backbone_3d"]
    inner = sum(tot["spans"][k]["device_ms"] for k in
                ("active_set", "positions", "posgather_conv", "dense_conv"))
    assert bb["self_ms"] == pytest.approx(bb["device_ms"] - inner)
    # every program span is a named event of the profile
    names = {e.name for e in prof.events()}
    assert set(PARENTS) <= names, set(PARENTS) - names


def test_self_ms_on_a_synthetic_tree():
    def run():
        with trace.span("root", scans=3):
            time.sleep(0.02)
            with trace.span("a"):
                time.sleep(0.01)
                with trace.span("leaf"):
                    time.sleep(0.01)
            with trace.span("a"):
                time.sleep(0.005)
            with trace.span("b"):
                time.sleep(0.005)
        with trace.span("tail"):
            time.sleep(0.005)

    profiled(run)
    recs = trace.records()
    assert [(r["name"], r["parent"], r["batch"]) for r in recs] == [
        ("root", None, 0), ("a", "root", 0), ("leaf", "a", 0),
        ("a", "root", 0), ("b", "root", 0), ("tail", None, 0)]
    tot = trace.totals()
    s = tot["spans"]
    assert tot["scans"] == 3 and tot["batches"] == 1
    assert s["a"]["calls"] == 2
    assert s["root"]["self_ms"] == pytest.approx(
        s["root"]["device_ms"] - s["a"]["device_ms"] - s["b"]["device_ms"])
    assert s["a"]["self_ms"] == pytest.approx(
        s["a"]["device_ms"] - s["leaf"]["device_ms"])
    for leaf in ("leaf", "b", "tail"):
        assert s[leaf]["self_ms"] == s[leaf]["device_ms"]
    # the sleeps bound each self time from below
    assert s["root"]["self_ms"] >= 20 and s["a"]["self_ms"] >= 15
    assert s["leaf"]["self_ms"] >= 10 and s["tail"]["self_ms"] >= 5
    assert s["root"]["device_ms"] >= 50
    for t in s.values():    # off CUDA the host clock is the device's
        assert t["device_ms"] == pytest.approx(t["host_ms"], abs=0.05)


def test_reset_clears_the_records():
    profiled(lambda: trace.span("root", scans=1).__enter__().__exit__())
    assert trace.records()
    trace.reset()
    assert trace.records() == []
    assert trace.totals() == {"spans": {}, "scans": 0, "batches": 0}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("root", scans=1):
            pass
    assert trace.records()[0]["batch"] == 0


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(narrow, accum):
    cfg, _, det, batch = narrow
    det = copy.deepcopy(det)
    tx, _ = build_optimizer(det.parameters(), {
        "OPTIMIZER": "adam", "LR": 1e-4, "WEIGHT_DECAY": 0.0,
        "GRAD_NORM_CLIP": 10.0}, 10)
    step = make_train_step(det, tx, accum_steps=accum)
    profiled(lambda: step(batch))
    recs = trace.records()
    roots = [(r["name"], r["batch"], r["scans"]) for r in recs
             if r["parent"] is None]
    want = []
    for i in range(accum):
        want += [("forward", i, B // accum), ("loss", i, None),
                 ("backward", i, None)]
    assert roots == want + [("optimizer", accum - 1, None)]
    parents = {(r["name"], r["parent"]) for r in recs}
    assert ("assign", "loss") in parents
    # the backward's kernels: K2 transposed, K4 for dW, K3 transposed for
    # the strided convs
    under = {r["name"] for r in recs if r["parent"] == "backward"}
    assert {"posgather_conv", "windowed_dw", "windowed_conv"} <= under
    tot = trace.totals()
    assert tot["scans"] == B and tot["batches"] == accum
    assert tot["spans"]["assign"]["calls"] == accum
    assert tot["spans"]["optimizer"]["calls"] == 1
