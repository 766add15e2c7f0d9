"""The port's Lyft, Custom, Argo2 and Pandaset layer (datasets/
misc_infos.py, misc_datasets.py, lyft_eval.py, argo2_eval.py, the
create_infos CLI's lyft, pandaset and argo2 modes) against the JAX
package's.

Trees come from chip_smoke.write_misc_trees at a small size (the writer of
the smoke run's phase 14: Lyft as its raw release, the other three as info
pickles); the Pandaset and Argo2 raw trees of tests/test_misc_infos.py go
through both packages' info generation (they need pandas, as both packages
do). Tolerances: infos and the loaders' items at the same seed (the
reference draws from numpy's global state after ``np.random.seed(s)``, the
port from the dataset's ``RandomState(s)``) bit for bit; the evaluations'
numbers within 1e-5 absolute (tests/test_torch_waymo.py::close: the Lyft
and Custom IoUs come from the two packages' float32 rotated-IoU ops, Argo2
and Pandaset are numpy on both sides)."""

import copy
import pickle

import numpy as np
import pytest

import chip_smoke
import findnpropagate_torch.datasets.argo2_eval as TAE
import findnpropagate_torch.datasets.lyft_eval as TLE
import findnpropagate_torch.datasets.misc_datasets as TMD
import findnpropagate_torch.datasets.misc_infos as TMI
import findnpropagate_tpu.datasets.argo2_eval as JAE
import findnpropagate_tpu.datasets.lyft_eval as JLE
import findnpropagate_tpu.datasets.misc_datasets as JMD
import findnpropagate_tpu.datasets.misc_infos as JMI
import test_official_evals as REF_CASES
from findnpropagate_torch import config as cfg_mod
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets import build_dataloader as torch_loader
from findnpropagate_torch.tools import create_infos
from findnpropagate_tpu.config import EDict as JEDict
from test_torch_datasets import assert_same
from test_torch_waymo import close, twin

DATASETS = ("LyftDataset", "CustomDataset", "Argo2Dataset",
            "PandasetDataset")
# eval_utils' simple mAP of perfect detections: its 101-point curve ends at
# recall 1 with precision 0, so the last of the 101 samples counts 0
SIMPLE_PERFECT = 100 / 101


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("misc")
    roots = chip_smoke.write_misc_trees(root, frames=2, points=12000,
                                        n_objects=6, sweeps=3)
    JMI.create_lyft_infos(roots["LyftDataset"], max_sweeps=3)
    return roots


def small_cfg(name, root):
    cfg = dict(chip_smoke.misc_cfg(cfg_mod, name, root))
    cfg["CAPACITIES"] = dict(cfg["CAPACITIES"], MAX_POINTS=40000,
                             MAX_VOXELS=4000)
    if name == "LyftDataset":
        cfg["MAX_SWEEPS"] = 3
    return cfg


def test_create_lyft_infos_matches_jax(trees, tmp_path):
    got = TMI.create_lyft_infos(trees["LyftDataset"], tmp_path, max_sweeps=3)
    for split in ("train", "val"):
        mine = pickle.loads(got[split].read_bytes())
        assert_same(mine, pickle.loads((trees["LyftDataset"] /
                                        f"lyft_infos_{split}.pkl")
                                       .read_bytes()))
        assert len(mine) == 2 and len(mine[0]["sweeps"]) == 2
    assert create_infos.main(["lyft", "--data_path",
                              str(trees["LyftDataset"]), "--save_path",
                              str(tmp_path / "cli"), "--max_sweeps",
                              "3"]) == 0
    assert_same(pickle.loads((tmp_path / "cli" / "lyft_infos_val.pkl")
                             .read_bytes()),
                pickle.loads(got["val"].read_bytes()))


@pytest.mark.parametrize("mode", ["pandaset", "argo2"])
def test_pandas_infos_match_jax(tmp_path, mode):
    """Pandaset and Argo2 read pandas pickles and feather files (pandas is
    imported where it is used, in both packages)."""
    pytest.importorskip("pandas")
    import test_misc_infos as REF

    if mode == "pandaset":
        REF.make_pandaset_tree(tmp_path, n_seq=3)
        kw = {"sequences": {"train": ["000", "001"], "val": ["002"]}}
    else:
        REF.make_argo2_tree(tmp_path)
        kw = {"splits": ("train",)}
    fn = f"create_{mode}_infos"
    want = getattr(JMI, fn)(tmp_path, tmp_path / "j", **kw)
    got = getattr(TMI, fn)(tmp_path, tmp_path / "t", **kw)
    assert set(got) == set(want)
    for split in got:
        assert_same(pickle.loads(got[split].read_bytes()),
                    pickle.loads(want[split].read_bytes()))
    for f in (tmp_path / "j").rglob("*.*"):
        if f.suffix in (".npy", ".bin"):
            assert (tmp_path / "t" / f.relative_to(tmp_path / "j")
                    ).read_bytes() == f.read_bytes()
    assert create_infos.main([mode, "--data_path", str(tmp_path),
                              "--save_path", str(tmp_path / "cli")]) == 0
    assert (tmp_path / "cli" / f"{mode}_infos_train.pkl").exists()


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("training", [True, False])
def test_items_match_jax(trees, name, training):
    """Each loader's items at the same seed through its yaml's pipeline
    (its gt_sampling databases, where it names one, are absent and
    skipped)."""
    cfg = small_cfg(name, trees[name])
    classes = list(chip_smoke.MISC_NAMES[name])
    np.random.seed(5)
    jds = getattr(JMD, name)(JEDict(copy.deepcopy(cfg)), classes,
                             training=training)
    want = [jds[i] for i in range(len(jds))]
    tds = getattr(TMD, name)(EDict(copy.deepcopy(cfg)), classes,
                             training=training,
                             rng=np.random.RandomState(5))
    got = [tds[i] for i in range(len(tds))]
    assert_same(got, want)
    assert len(got) == 2 and all(len(i["gt_boxes"]) for i in got)
    ds, loader, _ = torch_loader(EDict(copy.deepcopy(cfg)), classes,
                                 batch_size=2, training=training,
                                 prefetch=0)
    assert isinstance(ds, getattr(TMD, name))
    assert next(iter(loader))["points"].shape[0] == 2


@pytest.mark.parametrize("name", DATASETS)
def test_evaluation_of_ground_truth_matches_jax(trees, name):
    """The ground truth as detections: each dataset's evaluation equal to
    the JAX package's, with the perfect score the JAX tests expect (Lyft
    and Argo2 mAP 1). Custom's KITTI-protocol AP is 0 in both packages
    (its infos carry no 2D boxes); Pandaset has no official evaluation
    and returns an empty result; the simple mAP of both is perfect."""
    cfg = small_cfg(name, trees[name])
    classes = list(chip_smoke.MISC_NAMES[name])
    tds = getattr(TMD, name)(EDict(copy.deepcopy(cfg)), classes,
                             training=False)
    jds = getattr(JMD, name)(JEDict(copy.deepcopy(cfg)), classes,
                             training=False)
    dets = chip_smoke.gt_as_detections(tds)
    got = tds.evaluation(copy.deepcopy(dets), classes)
    close(got, jds.evaluation(copy.deepcopy(dets), classes))
    res = got[1]
    if name in ("LyftDataset", "Argo2Dataset"):
        assert res["mAP"] == pytest.approx(1.0), res
    elif name == "CustomDataset":
        # the infos carry no 2D boxes, kitti_eval's gate ignores every gt:
        # all 0, as in the JAX package
        assert res["mAP_3d_moderate_R40"] == 0.0
        assert all(v == 0.0 for v in res.values())
        simple = tds.evaluation(copy.deepcopy(dets), classes,
                                eval_metric="simple")
        close(simple, jds.evaluation(copy.deepcopy(dets), classes,
                                     eval_metric="simple"))
        assert simple[1]["mAP"] == pytest.approx(SIMPLE_PERFECT)
    else:
        assert got == ("", {})
        simple = tds.evaluation(copy.deepcopy(dets), classes,
                                eval_metric="simple")
        close(simple, jds.evaluation(copy.deepcopy(dets), classes,
                                     eval_metric="simple"))
        assert simple[1]["mAP"] == pytest.approx(SIMPLE_PERFECT)


def random_frames(seed, classes, n_frames=3):
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for _ in range(n_frames):
        n = rng.randint(0, 8)
        b = np.zeros((n, 7))
        b[:, :2] = rng.uniform(-50, 50, (n, 2))
        b[:, 3:6] = rng.uniform(0.6, 5, (n, 3))
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
        names = np.array([classes[i] for i in rng.randint(0, len(classes),
                                                          n)])
        gts.append({"gt_boxes": b, "gt_names": names,
                    "num_points_in_gt": rng.randint(0, 5, n)})
        keep = rng.rand(n) < 0.8
        d = np.concatenate([b[keep], rng.uniform(-50, 50, (2, 7))])
        d[:, :3] += rng.normal(0, 0.3, (len(d), 3))
        d[-2:, 3:6] = np.abs(d[-2:, 3:6]) + 0.5
        dets.append({"boxes": d, "scores": rng.rand(len(d)),
                     "name": np.concatenate([names[keep], np.array(
                         [classes[i] for i in rng.randint(0, len(classes),
                                                          2)])])})
    return gts, dets


@pytest.mark.parametrize("seed", [0, 1])
def test_lyft_and_argo2_evals_match_jax(seed):
    classes = ["car", "truck", "pedestrian"]
    gts, dets = random_frames(seed, classes)
    close(TLE.lyft_eval(copy.deepcopy(gts), copy.deepcopy(dets), classes),
          JLE.lyft_eval(gts, dets, classes))
    close(TAE.argo2_eval(copy.deepcopy(gts), copy.deepcopy(dets), classes),
          JAE.argo2_eval(gts, dets, classes))


@pytest.mark.parametrize("case", sorted(
    n for n in dir(REF_CASES) if n.startswith(("test_lyft", "test_argo2"))))
def test_reference_eval_cases_match_jax(case, monkeypatch):
    """The Lyft and Argo2 cases of tests/test_official_evals.py, with each
    call of the evaluators there (imported inside the cases) also made to
    the port's and held equal."""
    calls = []
    for mod_ref, mod_port, names in (
            (JLE, TLE, ("get_ap", "lyft_eval", "recall_precision")),
            (JAE, TAE, ("argo2_eval",))):
        for name in names:
            monkeypatch.setattr(mod_ref, name,
                                twin(mod_ref, mod_port, name, calls))
    getattr(REF_CASES, case)()
    assert calls
