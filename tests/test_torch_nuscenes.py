"""The port's nuScenes data layer (datasets/nuscenes_infos.py,
datasets/nuscenes.py, datasets/nuscenes_eval.py, datasets/eval_utils.py,
tools/create_infos.py) against the JAX package's, on the trees of
tests/test_dataset_bootstrap.py, on a tree with a sweep chain, moving
objects and ego rotation over three scenes, and on the inputs of
tests/test_nuscenes_eval.py.

Everything is numpy on both sides, so every comparison is bit for bit
(tolerance 0): the infos, the gt database (its dbinfos and its point
files), the dataset's items and CBGS-resampled infos at the same seed (the
reference draws from numpy's global state after ``np.random.seed(s)``, the
port from the dataset's ``RandomState(s)``), and the evaluations' result
strings and dictionaries."""

import copy
import json
import pickle

import numpy as np
import pytest
import yaml

import findnpropagate_torch.datasets.eval_utils as TEU
import findnpropagate_torch.datasets.nuscenes_eval as TNE
import findnpropagate_torch.datasets.nuscenes_infos as TNI
import findnpropagate_tpu.datasets.eval_utils as JEU
import findnpropagate_tpu.datasets.nuscenes_eval as JNE
import findnpropagate_tpu.datasets.nuscenes_infos as JNI
import test_nuscenes_eval as REF_CASES
from findnpropagate_torch import datasets as TD
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.nuscenes import NuScenesDataset as TNus
from findnpropagate_torch.tools import create_infos
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets.nuscenes import NuScenesDataset as JNus
from test_dataset_bootstrap import make_nuscenes_tree
from test_torch_datasets import assert_same

VERSION = "v1.0-mini"
CLASSES = ["car", "truck", "pedestrian"]
ALL = ["car", "truck", "pedestrian", "bicycle", "traffic_cone"]
GENERAL = {"car": "vehicle.car", "truck": "vehicle.truck",
           "pedestrian": "human.pedestrian.adult",
           "bicycle": "vehicle.bicycle",
           "traffic_cone": "movable_object.trafficcone"}
SIZES = {"car": (1.9, 4.5, 1.6), "truck": (2.5, 7.0, 2.8),
         "pedestrian": (0.7, 0.8, 1.7), "bicycle": (0.7, 1.8, 1.3),
         "traffic_cone": (0.4, 0.4, 1.0)}


def yaw_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def write_tree(root, seed=0, scenes=3, samples=3, sweeps=2, n_pts=4000,
               objects=6):
    """A nuScenes-layout tree: JSON tables of VERSION, key frames under
    samples/LIDAR_TOP and a chain of `sweeps` non-key frames before each,
    under sweeps/LIDAR_TOP, objects that move from sample to sample (each
    an instance with prev / next links), an ego that turns."""
    rng = np.random.RandomState(seed)
    t = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose",
                         "calibrated_sensor", "sample_annotation",
                         "instance", "attribute", "category")}
    t["calibrated_sensor"].append({
        "token": "cs_lidar", "translation": [0.94, 0.0, 1.84],
        "rotation": yaw_quat(-0.02), "camera_intrinsic": []})
    t["attribute"] = [{"token": f"attr{i}", "name": n} for i, n in enumerate(
        ["vehicle.parked", "vehicle.moving", "pedestrian.standing",
         "cycle.without_rider"])]
    t["category"] = [{"token": f"cat_{n}", "name": g}
                     for n, g in GENERAL.items()]
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True)
    (root / "sweeps" / "LIDAR_TOP").mkdir(parents=True)
    ts = 1_000_000
    for s in range(scenes):
        t["scene"].append({"token": f"scene{s}", "name": f"scene-{s:04d}"})
        names = [ALL[rng.randint(len(ALL))] for _ in range(objects)]
        start = rng.uniform(-15, 15, (objects, 2))
        vel = rng.uniform(-2, 2, (objects, 2))
        yaws = rng.uniform(-np.pi, np.pi, objects)
        for o, n in enumerate(names):
            t["instance"].append({"token": f"inst{s}_{o}",
                                  "category_token": f"cat_{n}"})
        prev_sd, prev_sample = "", ""
        for k in range(samples):
            ego_xy = np.array([100.0 + 3 * s, 50.0 + 2 * k])
            ego_yaw = 0.1 * k + 0.3 * s
            for w in range(sweeps + 1):
                ts += 50_000
                key = w == sweeps
                sd = f"sd{s}_{k}_{w}"
                fname = (f"samples/LIDAR_TOP/{sd}.bin" if key
                         else f"sweeps/LIDAR_TOP/{sd}.bin")
                pts = np.zeros((n_pts, 5), np.float32)
                pts[:, :2] = rng.uniform(-20, 20, (n_pts, 2))
                pts[:, 2] = rng.uniform(-2, 1, n_pts)
                pts[:, 3] = rng.uniform(0, 255, n_pts)
                pts[:, 4] = rng.randint(0, 32, n_pts)
                pts.tofile(root / fname)
                t["ego_pose"].append({
                    "token": f"pose_{sd}", "timestamp": ts,
                    "translation": [*(ego_xy - 0.05 * (sweeps - w)), 0.0],
                    "rotation": yaw_quat(ego_yaw - 0.01 * (sweeps - w))})
                t["sample_data"].append({
                    "token": sd, "sample_token": f"samp{s}_{k}",
                    "ego_pose_token": f"pose_{sd}",
                    "calibrated_sensor_token": "cs_lidar", "timestamp": ts,
                    "filename": fname, "prev": prev_sd, "next": "",
                    "is_key_frame": key})
                if prev_sd:
                    t["sample_data"][-2]["next"] = sd
                prev_sd = sd
            token = f"samp{s}_{k}"
            t["sample"].append({
                "token": token, "timestamp": ts, "scene_token": f"scene{s}",
                "data": {"LIDAR_TOP": prev_sd}, "prev": prev_sample,
                "next": ""})
            if prev_sample:
                t["sample"][-2]["next"] = token
            prev_sample = token
            for o, n in enumerate(names):
                xy = ego_xy + start[o] + vel[o] * 0.5 * k
                w_, l_, h_ = SIZES[n]
                t["sample_annotation"].append({
                    "token": f"ann{s}_{k}_{o}", "sample_token": token,
                    "instance_token": f"inst{s}_{o}",
                    "translation": [*xy, h_ / 2 - 1.8],
                    "size": [w_, l_, h_], "rotation": yaw_quat(yaws[o]),
                    "num_lidar_pts": int(rng.randint(0, 40)),
                    "num_radar_pts": int(rng.randint(0, 3)),
                    "prev": f"ann{s}_{k - 1}_{o}" if k else "",
                    "next": f"ann{s}_{k + 1}_{o}" if k < samples - 1 else "",
                    "attribute_tokens": [f"attr{rng.randint(4)}"]
                    if n != "traffic_cone" else []})
    (root / VERSION).mkdir()
    for name, rows in t.items():
        (root / VERSION / f"{name}.json").write_text(json.dumps(rows))
    return root


def both_infos(tmp_path, root, **kw):
    (tmp_path / "j").mkdir(exist_ok=True)
    (tmp_path / "t").mkdir(exist_ok=True)
    jout = JNI.create_nuscenes_infos(root, tmp_path / "j", **kw)
    tout = TNI.create_nuscenes_infos(root, tmp_path / "t", **kw)
    assert set(jout) == set(tout)
    return {k: [pickle.loads(p.read_bytes()) for p in (jout[k], tout[k])]
            for k in jout}, jout, tout


def test_bootstrap_tree_infos_match_jax(tmp_path):
    root = make_nuscenes_tree(tmp_path / "raw", version=VERSION)
    infos, _, _ = both_infos(tmp_path, root, version=VERSION, max_sweeps=2)
    for want, got in infos.values():
        assert_same(got, want)
    tables = TNI.NuScenesTables(root, VERSION)
    assert tables.sample_anns("samp0")[0]["category_name"] == "vehicle.car"


@pytest.mark.parametrize("max_sweeps", [1, 3, 10])
def test_sweep_tree_infos_and_gt_database_match_jax(tmp_path, max_sweeps):
    """Sweeps walk the sample_data chain (and repeat its last entry past
    its start); velocities come from the prev / next annotations; every
    8th scene is val."""
    root = write_tree(tmp_path / "raw")
    infos, jout, tout = both_infos(tmp_path, root, version=VERSION,
                                   max_sweeps=max_sweeps)
    for want, got in infos.values():
        assert_same(got, want)
    train = infos["train"][1]
    assert len(train) == 6 and len(infos["val"][1]) == 3
    assert all(len(i["sweeps"]) == max_sweeps - 1 for i in train)
    assert np.abs(train[0]["gt_boxes"][:, 7:9]).max() > 0
    jdb = JNI.create_groundtruth_database(root, jout["train"],
                                          tmp_path / "j")
    tdb = TNI.create_groundtruth_database(root, tout["train"],
                                          tmp_path / "t")
    want, got = (pickle.loads(p.read_bytes()) for p in (jdb, tdb))
    assert_same(got, want)
    for lst in got.values():
        for info in lst:
            assert (tmp_path / "t" / info["path"]).read_bytes() == \
                (tmp_path / "j" / info["path"]).read_bytes()


def test_create_infos_cli(tmp_path):
    root = write_tree(tmp_path / "raw", scenes=2, samples=2)
    rc = create_infos.main(["nuscenes", "--data_path", str(root),
                            "--version", VERSION, "--max_sweeps", "3",
                            "--gt_database", "--classes", "car", "truck"])
    assert rc == 0
    want = JNI.create_nuscenes_infos(root, tmp_path, version=VERSION,
                                     max_sweeps=3)
    got = pickle.loads((root / "nuscenes_infos_3sweeps_train.pkl")
                       .read_bytes())
    assert_same(got, pickle.loads(want["train"].read_bytes()))
    db = pickle.loads((root / "nuscenes_dbinfos_train.pkl").read_bytes())
    assert set(db) <= {"car", "truck"} and db
    # the waymo mode on a tree without raw_data/ finds no sequence
    assert create_infos.main(["waymo", "--data_path", str(root)]) == 0
    assert not (root / "waymo_processed_data").exists()


def dataset_cfg(root, max_sweeps=3, cbgs=True, gt_sampling=True):
    with open("tools/cfgs/dataset_configs/nuscenes_dataset.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(DATA_PATH=str(root), VERSION=VERSION, MAX_SWEEPS=max_sweeps,
               BALANCED_RESAMPLING=cbgs,
               INFO_PATH={"train": [f"nuscenes_infos_{max_sweeps}sweeps_"
                                    "train.pkl"],
                          "test": [f"nuscenes_infos_{max_sweeps}sweeps_"
                                   "val.pkl"]},
               CAPACITIES=dict(cfg["CAPACITIES"], MAX_POINTS=20000))
    augs = cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]
    sampling = dict(augs[0], DB_INFO_PATH=["nuscenes_dbinfos_train.pkl"],
                    PREPARE={"filter_by_min_points": ["car:2", "truck:2"]},
                    SAMPLE_GROUPS=["car:4", "truck:3", "pedestrian:2"])
    cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"] = \
        ([sampling] if gt_sampling else []) + augs[1:]
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_tree(tmp_path_factory.mktemp("nus") / "raw")
    out = JNI.create_nuscenes_infos(root, version=VERSION, max_sweeps=3)
    JNI.create_groundtruth_database(root, out["train"])
    return root


@pytest.mark.parametrize("training", [True, False])
def test_dataset_items_match_jax(tree, training):
    """CBGS resampling, sweep draws, gt_sampling and the augmentations of
    the training pipeline (or the test pipeline), item by item."""
    cfg = dataset_cfg(tree)
    np.random.seed(7)
    jds = JNus(JEDict(copy.deepcopy(cfg)), CLASSES, training=training)
    jitems = [jds[i] for i in range(len(jds))]
    tds = TNus(EDict(copy.deepcopy(cfg)), CLASSES, training=training,
               rng=np.random.RandomState(7))
    assert_same(tds.infos, jds.infos)
    titems = [tds[i] for i in range(len(tds))]
    assert_same(titems, jitems)
    if training:
        assert len(tds) != 6          # resampled
        assert any(len(i["gt_boxes"]) > 0 for i in titems)
        assert titems[0]["points"].shape[1] == 5


def test_build_dataloader_builds_nuscenes(tree):
    cfg = dataset_cfg(tree, gt_sampling=False)
    ds, loader, _ = TD.build_dataloader(EDict(cfg), CLASSES, batch_size=2,
                                        seed=3, prefetch=0)
    assert isinstance(ds, TNus)
    batch = next(iter(loader))
    assert batch["points"].shape == (2, 20000, 5)
    assert batch["gt_boxes"].shape == (2, cfg["CAPACITIES"]["MAX_GT"], 8)


def detections(rng, infos, noise=0.3, extra=3):
    """Per info: its ground truths moved by up to `noise` metres, some
    dropped, plus a few false positives, scored and labelled over ALL."""
    dets = []
    for info in infos:
        g = info["gt_boxes"]
        keep = rng.rand(len(g)) < 0.8
        boxes = g[keep].copy()
        boxes[:, :2] += rng.uniform(-noise, noise, (len(boxes), 2))
        fp = np.zeros((extra, 9), np.float32)
        fp[:, :2] = rng.uniform(-20, 20, (extra, 2))
        fp[:, 3:6] = [4.0, 2.0, 1.5]
        boxes = np.concatenate([boxes, fp]).astype(np.float32)
        labels = np.array([ALL.index(n) + 1 for n in info["gt_names"][keep]]
                          + list(rng.randint(1, len(ALL) + 1, extra)))
        dets.append({"boxes": boxes, "scores": rng.rand(len(boxes)),
                     "labels": labels.astype(np.int64)})
    return dets


@pytest.mark.parametrize("metric", ["nuscenes", "simple"])
def test_dataset_evaluation_matches_jax(tree, metric):
    """The known / unknown evaluation over ALL with the first 3 known."""
    cfg = dataset_cfg(tree, cbgs=False)
    jds = JNus(JEDict(copy.deepcopy(cfg)), ALL, training=False)
    tds = TNus(EDict(copy.deepcopy(cfg)), ALL, training=False)
    dets = detections(np.random.RandomState(0), tds.infos)
    want = jds.evaluation(copy.deepcopy(dets), ALL, eval_metric=metric,
                          known_classes=CLASSES)
    got = tds.evaluation(copy.deepcopy(dets), ALL, eval_metric=metric,
                         known_classes=CLASSES)
    assert_same(got, want)
    res = got[1]
    assert {"AP_B", "AP_N", "AR_N"} <= set(res)
    if metric == "nuscenes":
        assert 0 < res["NDS"] <= 1 and np.isfinite(res["mAP"])


def twin(module_ref, module_port, name, calls):
    """module_ref.name that also runs the port's function on a copy of
    the same arguments and holds the two results equal."""
    ref, mine = getattr(module_ref, name), getattr(module_port, name)

    def run(*a, **kw):
        got = mine(*copy.deepcopy(a), **copy.deepcopy(kw))
        want = ref(*a, **kw)
        assert_same(got, want, name)
        calls.append(name)
        return want
    return run


@pytest.mark.parametrize("case", sorted(
    n for n in dir(REF_CASES) if n.startswith("test_")))
def test_reference_eval_cases_match_jax(case, monkeypatch):
    """Every case of tests/test_nuscenes_eval.py, with each call of the
    evaluator there also made to the port's and held equal."""
    calls = []
    for name in ("accumulate", "calc_ap", "calc_tp",
                 "nuscenes_protocol_eval"):
        monkeypatch.setattr(REF_CASES, name, twin(JNE, TNE, name, calls))
    getattr(REF_CASES, case)()
    assert calls


def test_simple_map_eval_matches_jax():
    rng = np.random.RandomState(4)
    gts, dets = [], []
    for _ in range(5):
        n = rng.randint(0, 6)
        g = np.zeros((n, 7), np.float32)
        g[:, :2] = rng.uniform(-30, 30, (n, 2))
        names = np.array([ALL[i] for i in rng.randint(0, len(ALL), n)])
        gts.append({"gt_boxes": g, "gt_names": names})
        d = np.concatenate([g, rng.uniform(-30, 30, (2, 7))]).astype(
            np.float32)
        d[:n, :2] += rng.uniform(-1, 1, (n, 2))
        dets.append({"boxes": d, "scores": rng.rand(len(d)),
                     "labels": rng.randint(1, len(ALL) + 1, len(d))})
    want = JEU.simple_map_eval(dets, gts, ALL, known_classes=CLASSES)
    got = TEU.simple_map_eval(dets, gts, ALL, known_classes=CLASSES)
    assert_same(got, want)
