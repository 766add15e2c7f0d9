"""The port's ONCE data layer (datasets/misc_infos.py::create_once_infos,
datasets/once.py, datasets/once_eval.py, the create_infos CLI's once mode)
against the JAX package's.

Raw trees come from chip_smoke.write_once_tree at a small size (the writer
of the smoke run's phase 14), with one frame's annotations removed and
another's emptied. Tolerances: the infos and the loader's items at the same
seed (the reference draws from numpy's global state after
``np.random.seed(s)``, the port from the dataset's ``RandomState(s)``) are
bit for bit; the evaluations' numbers, whose IoUs come from the two
packages' rotated-IoU ops (torch and JAX, float32), within 1e-5 absolute
(tests/test_torch_waymo.py::close), and the IoU matrices within 1e-3
(IOU_ATOL)."""

import copy
import json
import pickle

import numpy as np
import pytest
import yaml

import chip_smoke
import findnpropagate_torch.datasets.misc_infos as TMI
import findnpropagate_torch.datasets.once_eval as TOE
import findnpropagate_tpu.datasets.misc_infos as JMI
import findnpropagate_tpu.datasets.once_eval as JOE
import test_official_evals as REF_CASES
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets import build_dataloader as torch_loader
from findnpropagate_torch.datasets.once import ONCEDataset as TOnce
from findnpropagate_torch.tools import create_infos
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets.once import ONCEDataset as JOnce
from test_torch_datasets import assert_same
from test_torch_waymo import close, twin

CLASSES = ["Car", "Bus", "Truck", "Pedestrian", "Cyclist"]
# the IoU matrices themselves: both ops clip the polygons in float32, and at
# 65 m from the origin their overlaps part by up to 4e-4 m^2 (the JAX op's
# 6.99699 and the port's 6.99738 against the float64 oracle's 6.99743 in
# tests/oracles.py on a pair of seed 0); no match flips, so the APs stay
# within 1e-5
IOU_ATOL = 1e-3


def write_tree(root):
    """Train: 4 frames of sequence 000076, the second without annos, the
    third with zero boxes (skipped by the info generation); val: 2
    frames."""
    chip_smoke.write_once_tree(root, {"train": ("000076", 4),
                                      "val": ("000080", 2)},
                               raw_points=3000, n_objects=6,
                               pcr=(-20.0, -20.0, -5.0, 20.0, 20.0, 3.0))
    fp = root / "data" / "000076" / "000076.json"
    seq = json.loads(fp.read_text())
    del seq["frames"][1]["annos"]
    seq["frames"][2]["annos"] = {"names": [], "boxes_3d": [],
                                 "boxes_2d": {"cam01": []}}
    fp.write_text(json.dumps(seq))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_tree(tmp_path_factory.mktemp("once") / "raw")
    JMI.create_once_infos(root)
    return root


def test_create_once_infos_matches_jax(tree, tmp_path):
    got = TMI.create_once_infos(tree, tmp_path)
    for split in ("train", "val"):
        mine = pickle.loads(got[split].read_bytes())
        assert_same(mine, pickle.loads(
            (tree / f"once_infos_{split}.pkl").read_bytes()))
    train = pickle.loads(got["train"].read_bytes())
    assert len(train) == 3 and "annos" not in train[1]
    assert train[0]["annos"]["num_points_in_gt"].dtype == np.int32
    assert (train[0]["annos"]["num_points_in_gt"] > 0).any()
    assert not (tmp_path / "once_dbinfos_train.pkl").exists()


def test_create_infos_cli_once(tree, tmp_path):
    assert create_infos.main(["once", "--data_path", str(tree),
                              "--save_path", str(tmp_path)]) == 0
    assert_same(pickle.loads((tmp_path / "once_infos_val.pkl").read_bytes()),
                pickle.loads((tree / "once_infos_val.pkl").read_bytes()))


def once_cfg(root):
    with open("tools/cfgs/dataset_configs/once_dataset.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(DATA_PATH=str(root),
               CAPACITIES=dict(cfg["CAPACITIES"], MAX_POINTS=4000,
                               MAX_VOXELS=2000))
    return cfg


@pytest.mark.parametrize("training", [True, False])
def test_dataset_items_match_jax(tree, training):
    """The yaml's pipeline: training keeps the annotated frames, and its
    gt_sampling names once_dbinfos_train.pkl, which create_once_infos does
    not write: the sampler skips the missing file in both packages."""
    cfg = once_cfg(tree)
    np.random.seed(3)
    jds = JOnce(JEDict(copy.deepcopy(cfg)), CLASSES, training=training)
    want = [jds[i] for i in range(len(jds))]
    tds = TOnce(EDict(copy.deepcopy(cfg)), CLASSES, training=training,
                rng=np.random.RandomState(3))
    assert_same(tds.infos, jds.infos)
    got = [tds[i] for i in range(len(tds))]
    assert_same(got, want)
    assert len(tds) == 2
    if training:
        sampler = tds.data_augmentor.queue[0]
        assert not sampler.enabled and not any(sampler.db_infos.values())
        assert all(len(i["gt_boxes"]) > 0 for i in got)


def test_build_dataloader_builds_once(tree):
    ds, loader, _ = torch_loader(EDict(once_cfg(tree)), CLASSES,
                                 batch_size=2, training=False, prefetch=0)
    assert isinstance(ds, TOnce)
    assert next(iter(loader))["points"].shape == (2, 4000, 4)


def random_frames(seed, n_frames=4):
    """Ground truths of the five classes at every distance bucket, and
    detections: jittered ground truths (some flipped in heading, some
    renamed) plus false positives."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for _ in range(n_frames):
        n = rng.randint(0, 9)
        b = np.zeros((n, 7))
        r, a = rng.uniform(2, 80, n), rng.uniform(-np.pi, np.pi, n)
        b[:, 0], b[:, 1] = r * np.cos(a), r * np.sin(a)
        b[:, 3:6] = rng.uniform(0.6, 5, (n, 3))
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
        names = np.array([CLASSES[i] for i in rng.randint(0, 5, n)])
        gts.append({"name": names, "boxes_3d": b})
        keep = rng.rand(n) < 0.8
        d = b[keep].copy()
        d[:, :3] += rng.normal(0, 0.1, (len(d), 3))
        d[:, 6] += np.where(rng.rand(len(d)) < 0.2, np.pi, 0.0)
        fp = np.zeros((2, 7))
        fp[:, :2] = rng.uniform(-60, 60, (2, 2))
        fp[:, 3:6] = [4.0, 2.0, 1.5]
        d = np.concatenate([d, fp])
        dn = np.concatenate([names[keep], np.array(
            [CLASSES[i] for i in rng.randint(0, 5, 2)])])
        dn[rng.rand(len(dn)) < 0.1] = "Pedestrian"
        dets.append({"boxes_3d": d, "score": rng.rand(len(d)), "name": dn})
    return gts, dets


@pytest.mark.parametrize("seed,superclass", [(0, True), (1, True),
                                             (2, False)])
def test_once_eval_matches_jax(seed, superclass):
    gts, dets = random_frames(seed)
    kw = {"use_superclass": superclass}
    want = JOE.once_eval(gts, dets, CLASSES, **kw)
    got = TOE.once_eval(copy.deepcopy(gts), copy.deepcopy(dets), CLASSES,
                        **kw)
    close(got, want)
    assert got[1]["AP_mean/overall"] > 0
    for g, d in zip(gts, dets):
        np.testing.assert_allclose(
            TOE.heading_gated_iou3d(g["boxes_3d"], d["boxes_3d"]),
            JOE.heading_gated_iou3d(g["boxes_3d"], d["boxes_3d"]), rtol=0,
            atol=IOU_ATOL)


def test_evaluation_of_cli_det_annos_scores_none(tree):
    """eval_ckpt's det_annos carry boxes / scores / labels, while once_eval
    reads boxes_3d / name / score: through the CLI every AP is 0 even for
    perfect boxes (the reference's trait), in both packages."""
    cfg = once_cfg(tree)
    tds = TOnce(EDict(copy.deepcopy(cfg)), CLASSES, training=False)
    jds = JOnce(JEDict(copy.deepcopy(cfg)), CLASSES, training=False)
    dets = [{"boxes": np.asarray(i["annos"]["boxes_3d"]),
             "scores": np.ones(len(i["annos"]["name"])),
             "labels": np.array([CLASSES.index(n) + 1
                                 for n in i["annos"]["name"]])}
            for i in tds.infos]
    got = tds.evaluation(copy.deepcopy(dets), CLASSES, known_classes=None)
    close(got, jds.evaluation(copy.deepcopy(dets), CLASSES))
    assert got[1] and all(v == 0.0 for v in got[1].values())
    named = [{"boxes_3d": d["boxes"], "score": d["scores"],
              "name": np.array([CLASSES[lb - 1] for lb in d["labels"]])}
             for d in dets]
    got = tds.evaluation(copy.deepcopy(named), CLASSES)
    close(got, jds.evaluation(copy.deepcopy(named), CLASSES))
    assert got[1]["AP_mean/overall"] > 99.0
    close(tds.evaluation(copy.deepcopy(dets), CLASSES, eval_metric="simple"),
          jds.evaluation(copy.deepcopy(dets), CLASSES, eval_metric="simple"))


@pytest.mark.parametrize("case", sorted(
    n for n in dir(REF_CASES) if n.startswith("test_once")))
def test_reference_once_eval_cases_match_jax(case, monkeypatch):
    """The ONCE cases of tests/test_official_evals.py, with each call of
    the evaluator there also made to the port's and held equal."""
    calls = []
    for name in ("once_eval", "heading_gated_iou3d"):
        monkeypatch.setattr(REF_CASES, name, twin(JOE, TOE, name, calls))
    getattr(REF_CASES, case)()
    assert calls
