"""The port's KITTI data layer (utils/calibration_kitti.py,
datasets/kitti.py, datasets/kitti_eval.py, gt_sampling's USE_ROAD_PLANE,
tools/create_infos.py) against the JAX package's, on the tree of
tests/test_dataset_bootstrap.py, on a tree of several frames with
DontCare, Van and Pedestrian labels and road planes, and on the inputs of
tests/test_kitti_eval.py.

Tolerances: everything numpy is bit for bit (infos, gt database, items at
the same seed, calibration, labels); the evaluations' results are held
within 1e-9 relative, because their IoUs come from the two packages'
rotated-IoU ops (torch and JAX, float32), which round differently in the
last bits (no case sits within that of an IoU threshold)."""

import copy
import pickle

import numpy as np
import pytest
import yaml

import findnpropagate_torch.datasets.kitti as TK
import findnpropagate_torch.datasets.kitti_eval as TKE
import findnpropagate_torch.utils.calibration_kitti as TC
import findnpropagate_tpu.datasets.kitti as JK
import findnpropagate_tpu.datasets.kitti_eval as JKE
import findnpropagate_tpu.utils.calibration_kitti as JC
import test_kitti_eval as REF_CASES
from findnpropagate_torch import datasets as TD
from findnpropagate_torch.config import EDict
from findnpropagate_torch.tools import create_infos
from findnpropagate_tpu.config import EDict as JEDict
from test_dataset_bootstrap import make_kitti_tree
from test_torch_datasets import assert_same

CLASSES = ["Car", "Pedestrian", "Cyclist"]
P2 = "P2: 721.5 0 609.6 44.9 0 721.5 172.9 0.2 0 0 1 0.003"
R0 = "R0_rect: 0.9999 0.0098 -0.0074 -0.0099 0.9999 -0.0043 0.0074 0.0044 1"
TR = ("Tr_velo_to_cam: 0.0075 -0.9999 -0.0006 -0.0041 0.0148 0.0007 "
      "-0.9999 -0.0763 0.9999 0.0075 0.0148 -0.2718")


def write_tree(root, frames=4, seed=0):
    """KITTI layout: velodyne, label_2 (cars, vans, pedestrians, DontCare
    last, as KITTI writes them), calib, planes, ImageSets."""
    rng = np.random.RandomState(seed)
    for d in ("velodyne", "calib", "label_2", "planes"):
        (root / "training" / d).mkdir(parents=True)
    (root / "ImageSets").mkdir()
    ids = [f"{i:06d}" for i in range(frames)]
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids[:-1]) + "\n")
    (root / "ImageSets" / "val.txt").write_text(ids[-1] + "\n")
    calib = JC.Calibration({"P2": np.array(P2.split()[1:], np.float32)
                            .reshape(3, 4),
                            "R0": np.array(R0.split()[1:], np.float32)
                            .reshape(3, 3),
                            "Tr_velo2cam": np.array(TR.split()[1:],
                                                    np.float32).reshape(3, 4)})
    for i in ids:
        (root / "training" / "calib" / f"{i}.txt").write_text(
            f"P0: 0\nP1: 0\n{P2}\nP3: {' '.join(['0'] * 12)}\n{R0}\n{TR}\n")
        (root / "training" / "planes" / f"{i}.txt").write_text(
            "# Plane\nWidth 4\nHeight 1\n"
            f"{rng.uniform(-0.02, 0.02):.4f} -1.0 "
            f"{rng.uniform(-0.02, 0.02):.4f} 1.65\n")
        lines, pts = [], []
        n = rng.randint(3, 7)
        for k in range(n):
            cls = ["Car", "Van", "Pedestrian", "Car"][k % 4]
            h, w, l = {"Pedestrian": (1.75, 0.6, 0.8),
                       "Van": (2.1, 1.9, 5.0)}.get(cls, (1.5, 1.7, 4.2))
            x, y = rng.uniform(6, 45), rng.uniform(-12, 12)
            heading = rng.uniform(-np.pi, np.pi)
            bottom = calib.lidar_to_rect(np.array([[x, y, -1.7]],
                                                  np.float32))[0]
            ry = -(np.pi / 2 + heading)
            top = rng.uniform(120, 200)
            lines.append(
                f"{cls} {rng.choice([0.0, 0.2, 0.4]):.2f} "
                f"{rng.randint(0, 3)} 0.0 {rng.uniform(0, 1000):.2f} "
                f"{top:.2f} {rng.uniform(1000, 1200):.2f} "
                f"{top + rng.uniform(15, 80):.2f} {h:.2f} {w:.2f} {l:.2f} "
                f"{bottom[0]:.2f} {bottom[1]:.2f} {bottom[2]:.2f} "
                f"{ry:.4f}")
            local = rng.uniform(-0.45, 0.45, (120, 3)) * [l, w, h]
            c, s = np.cos(heading), np.sin(heading)
            pts.append(np.stack([local[:, 0] * c - local[:, 1] * s + x,
                                 local[:, 0] * s + local[:, 1] * c + y,
                                 local[:, 2] - 1.7 + h / 2], -1))
        lines.append("DontCare -1 -1 -10 500 170 540 190 -1 -1 -1 -1000 "
                     "-1000 -1000 -10")
        (root / "training" / "label_2" / f"{i}.txt").write_text(
            "\n".join(lines) + "\n")
        bg = np.stack([rng.uniform(0, 60, 2000), rng.uniform(-30, 30, 2000),
                       rng.uniform(-2, 1, 2000)], -1)
        xyz = np.concatenate(pts + [bg])
        np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1).astype(
            np.float32).tofile(root / "training" / "velodyne" / f"{i}.bin")
    return root


def both_infos(tmp_path, root, splits=("train", "val")):
    out = {}
    for name, mod in (("j", JK), ("t", TK)):
        (tmp_path / name).mkdir(exist_ok=True)
        out[name] = mod.create_kitti_infos(root, tmp_path / name,
                                           splits=splits)
    return out["j"], out["t"]


@pytest.mark.parametrize("tree", ["bootstrap", "frames"])
def test_infos_and_gt_database_match_jax(tmp_path, tree):
    root = tmp_path / "raw"
    root.mkdir()
    if tree == "bootstrap":
        make_kitti_tree(root)
        splits = ("train",)
    else:
        write_tree(root)
        splits = ("train", "val")
    jout, tout = both_infos(tmp_path, root, splits)
    for s in splits:
        assert_same(pickle.loads(tout[s].read_bytes()),
                    pickle.loads(jout[s].read_bytes()))
    jdb = JK.create_groundtruth_database(root, jout["train"], tmp_path / "j")
    tdb = TK.create_groundtruth_database(root, tout["train"], tmp_path / "t")
    want, got = (pickle.loads(p.read_bytes()) for p in (jdb, tdb))
    assert_same(got, want)
    assert got["Car"] and all(
        (tmp_path / "t" / i["path"]).read_bytes()
        == (tmp_path / "j" / i["path"]).read_bytes()
        for lst in got.values() for i in lst)


def test_calibration_round_trips_match_jax(tmp_path):
    root = write_tree(tmp_path / "raw", frames=1)
    f = str(root / "training" / "calib" / "000000.txt")
    jc, tc = JC.Calibration(f), TC.Calibration(f)
    rng = np.random.RandomState(1)
    pts = np.stack([rng.uniform(2, 60, 50), rng.uniform(-20, 20, 50),
                    rng.uniform(-2, 1, 50)], -1).astype(np.float32)
    rect = tc.lidar_to_rect(pts)
    assert_same(rect, jc.lidar_to_rect(pts))
    np.testing.assert_allclose(tc.rect_to_lidar(rect), pts, atol=1e-4)
    assert_same(tc.rect_to_lidar(rect), jc.rect_to_lidar(rect))
    img, depth = tc.lidar_to_img(pts)
    assert_same((img, depth), jc.lidar_to_img(pts))
    back = tc.img_to_rect(img[:, 0], img[:, 1], rect[:, 2])
    assert_same(back, jc.img_to_rect(img[:, 0], img[:, 1], rect[:, 2]))
    np.testing.assert_allclose(back, rect, atol=1e-3)
    corners = rect[:16].reshape(2, 8, 3)
    assert_same(tc.corners3d_to_img_boxes(corners),
                jc.corners3d_to_img_boxes(corners))
    objs = TC.get_objects_from_label(str(root / "training" / "label_2"
                                         / "000000.txt"))
    jobjs = JC.get_objects_from_label(str(root / "training" / "label_2"
                                          / "000000.txt"))
    assert len(objs) == len(jobjs) > 1
    for o, j in zip(objs, jobjs):
        assert_same(vars(o), vars(j))
    assert_same(TC.objects_to_boxes_lidar(objs, tc),
                JC.objects_to_boxes_lidar(jobjs, jc))


def dataset_cfg(root, road_plane=True):
    with open("tools/cfgs/dataset_configs/kitti_dataset.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["DATA_PATH"] = str(root)
    sampling = dict(cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0],
                    USE_ROAD_PLANE=road_plane,
                    PREPARE={"filter_by_min_points": ["Car:5",
                                                      "Pedestrian:5"]},
                    SAMPLE_GROUPS=["Car:6", "Pedestrian:4"])
    cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0] = sampling
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_tree(tmp_path_factory.mktemp("kitti") / "raw", frames=5)
    out = JK.create_kitti_infos(root)
    JK.create_groundtruth_database(root, out["train"])
    return root


@pytest.mark.parametrize("road_plane", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_dataset_items_match_jax(tree, training, road_plane):
    """Items with calib and road_plane; in training, gt_sampling sets the
    pasted boxes and their points on the road plane (USE_ROAD_PLANE)."""
    cfg = dataset_cfg(tree, road_plane)
    np.random.seed(3)
    jds = JK.KittiDataset(JEDict(copy.deepcopy(cfg)), CLASSES,
                          training=training)
    jitems = [jds[i] for i in range(len(jds))]
    tds = TK.KittiDataset(EDict(copy.deepcopy(cfg)), CLASSES,
                          training=training, rng=np.random.RandomState(3))
    titems = [tds[i] for i in range(len(tds))]
    assert_same(titems, jitems)
    assert all({"calib", "road_plane"} <= set(i) for i in titems)
    if training:
        assert sum(len(i["gt_boxes"]) for i in titems) > 12


def test_road_plane_moves_the_pasted_boxes(tree):
    """The plane under each pasted box: with USE_ROAD_PLANE the boxes'
    heights differ from the database's, and equal the reference's."""
    on, off = [], []
    for flag, out in ((True, on), (False, off)):
        tds = TK.KittiDataset(EDict(dataset_cfg(tree, flag)), CLASSES,
                              training=True, rng=np.random.RandomState(3))
        tds.data_augmentor.queue = tds.data_augmentor.queue[:1]
        out.extend(tds[i]["gt_boxes"] for i in range(len(tds)))
    assert any(not np.array_equal(a, b) for a, b in zip(on, off))


def test_build_dataloader_builds_kitti(tree):
    cfg = dataset_cfg(tree)
    ds, loader, _ = TD.build_dataloader(EDict(cfg), CLASSES, batch_size=2,
                                        training=False, prefetch=0)
    assert isinstance(ds, TK.KittiDataset)
    batch = next(iter(loader))          # the val split: one frame
    assert batch["frame_id"] == ["000004"]
    assert batch["points"].shape == (1, cfg["CAPACITIES"]["MAX_POINTS"], 4)


def test_create_infos_cli(tmp_path):
    root = write_tree(tmp_path / "raw", frames=3)
    assert create_infos.main(["kitti", "--data_path", str(root),
                              "--gt_database"]) == 0
    want = JK.create_kitti_infos(root, tmp_path, splits=("train",))
    assert_same(pickle.loads((root / "kitti_infos_train.pkl").read_bytes()),
                pickle.loads(want["train"].read_bytes()))
    assert (root / "kitti_dbinfos_train.pkl").exists()


def assert_close(got, want, path="out"):
    """assert_same, but floats within 1e-9 relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-9,
                                   atol=1e-12, err_msg=path)


@pytest.mark.parametrize("case", sorted(
    n for n in dir(REF_CASES) if n.startswith("test_")))
def test_reference_eval_cases_match_jax(case, monkeypatch):
    """Every case of tests/test_kitti_eval.py, with each call of the
    evaluator there also made to the port's and held equal."""
    calls = []
    for name in ("eval_class", "kitti_eval", "_ap_curve", "_ap_r11",
                 "_ap_r40"):
        ref, mine = getattr(JKE, name), getattr(TKE, name)

        def run(*a, _ref=ref, _mine=mine, _name=name, **kw):
            got = _mine(*copy.deepcopy(a), **copy.deepcopy(kw))
            want = _ref(*a, **kw)
            assert_close(got, want, _name)
            calls.append(_name)
            return want
        monkeypatch.setattr(REF_CASES, name, run)
    getattr(REF_CASES, case)()
    assert calls


def test_dataset_evaluation_matches_jax(tree):
    cfg = dataset_cfg(tree)
    jds = JK.KittiDataset(JEDict(copy.deepcopy(cfg)), CLASSES,
                          training=False)
    tds = TK.KittiDataset(EDict(copy.deepcopy(cfg)), CLASSES,
                          training=False)
    jtr = JK.KittiDataset(JEDict(copy.deepcopy(cfg)), CLASSES,
                          training=True)
    infos = jtr.infos
    jds.infos, tds.infos = infos, copy.deepcopy(infos)
    rng = np.random.RandomState(0)
    dets = []
    for info in infos:
        a = info["annos"]
        m = a["name"] != "DontCare"
        boxes = a["gt_boxes_lidar"][:m.sum()].copy()
        boxes[:, :2] += rng.uniform(-0.3, 0.3, (len(boxes), 2))
        labels = np.array([CLASSES.index(n) + 1 if n in CLASSES else 1
                           for n in a["name"][m]])
        dets.append({"boxes": boxes, "scores": rng.rand(len(boxes)),
                     "labels": labels})
    want = jds.evaluation(copy.deepcopy(dets), CLASSES)
    got = tds.evaluation(copy.deepcopy(dets), CLASSES)
    assert_close(got, want)
    assert got[1]["Car_3d_moderate_R40"] > 0
