"""The port's ablation proposers (findnpropagate_torch/openvocab/
alt_proposers.py) and their clustering (utils/clustering.py) against the
JAX package's, on the CPU.

The proposers are host numpy on both sides and the same seeded inputs go
through both: outputs must be equal, element for element. The JAX package
clusters with scikit-learn (installed here); the port computes sklearn's
DBSCAN and HDBSCAN labels without it, held against sklearn itself on
seeded clouds, small and all-noise ones included. Every case of
tests/test_alt_proposers.py is run through both packages here (its MaskCLIP
and build_relabeler cases in tests/test_torch_box_classification.py)."""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from findnpropagate_tpu.openvocab import alt_proposers as jalt
from findnpropagate_torch.openvocab import alt_proposers as talt
from findnpropagate_torch.utils.clustering import dbscan, hdbscan
from test_box_classification import BOXES3D, project_box_2d
from test_frustum_proposer import make_camera

ROOT = Path(__file__).resolve().parents[1]
CLASS_NAMES = ["car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone"]


def assert_same(got, want):
    """Equal (boxes, scores, labels): numpy on both sides, same order."""
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def box_points(box, rng, n, spread=0.5):
    local = rng.uniform(-spread, spread, (n, 3)) * box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    return np.stack([local[:, 0] * c - local[:, 1] * s + box[0],
                     local[:, 0] * s + local[:, 1] * c + box[1],
                     local[:, 2] + box[2]], -1).astype(np.float32)


def scene(seed, n_obj, spread, bg=0):
    """Points of the test boxes (and background), their 2D boxes on the
    test camera: (points, det boxes, labels, scores, cams, lidar2image)."""
    l2i, _, _ = make_camera()
    rng = np.random.RandomState(seed)
    boxes = BOXES3D[:n_obj]
    pts = [box_points(b, rng, n, spread)
           for b, n in zip(boxes, (300, 120))]
    if bg:
        pts.append(rng.uniform(-30, 30, (bg, 3)).astype(np.float32))
    dets = np.stack([project_box_2d(b.astype(np.float64), l2i)
                     for b in boxes])
    return (np.concatenate(pts), dets, np.arange(1, n_obj + 1) * 2 - 1,
            np.linspace(0.9, 0.6, n_obj), np.zeros(n_obj, np.int64),
            l2i[None])


# ------------------------------------------------------------- clustering

def cloud(seed):
    """Seeded clouds of 1-600 points: blobs, duplicates, a label column,
    sparse (all-noise) ones."""
    rng = np.random.RandomState(seed)
    n = [1, 3, 5, 8, 11, 12, 40, 200, 600][seed % 9]
    k = rng.randint(1, 5)
    ctr = rng.uniform(-5, 5, (k, 3))
    x = ctr[rng.randint(k, size=n)] + rng.normal(
        0, rng.uniform(0.2, 1.5), (n, 3))
    if seed % 4 == 0:
        x = rng.uniform(-50, 50, (n, 3))             # sparse: all noise
    if seed % 5 == 0:
        x[: n // 3] = x[n // 3: 2 * (n // 3)]        # duplicate points
    if seed % 3 == 0:                                # pooled (xyz, label)
        x = np.concatenate([x, rng.randint(1, 4, (n, 1))], 1)
    return x.astype(np.float32), rng


@pytest.mark.parametrize("seed", range(27))
def test_dbscan_and_hdbscan_equal_sklearn(seed):
    """Labels equal to sklearn's DBSCAN(eps, min_samples) and
    HDBSCAN(min_cluster_size) with its defaults, numbering included."""
    cluster = pytest.importorskip("sklearn.cluster")
    x, rng = cloud(seed)
    eps, ms = rng.uniform(0.2, 1.2), rng.randint(1, 8)
    want = cluster.DBSCAN(eps=eps, min_samples=ms).fit_predict(x)
    np.testing.assert_array_equal(dbscan(x, eps, ms), want)
    mcs = rng.randint(2, 8)
    if len(x) > 1 and len(x) >= mcs:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            want = cluster.HDBSCAN(min_cluster_size=mcs).fit_predict(x)
        np.testing.assert_array_equal(hdbscan(x, mcs, device="cpu"), want)
    else:
        with pytest.raises(ValueError):
            hdbscan(x, mcs, device="cpu")


def test_dbscan_empty_and_hdbscan_below_min_cluster_size():
    assert dbscan(np.zeros((0, 3)), 0.5, 5).shape == (0,)
    # the reference's HDBSCANCluster: fewer points than min_cluster_size
    # are one cluster
    np.testing.assert_array_equal(
        talt._hdbscan(np.zeros((3, 4)), device="cpu"), [0, 0, 0])


def test_imports_neither_sklearn_nor_jax():
    """Importing every module of the port's openvocab and utils (and the
    extraction CLI) leaves sklearn and jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import findnpropagate_torch.openvocab as ov\n"
        "import findnpropagate_torch.utils as ut\n"
        "for pkg in (ov, ut):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "importlib.import_module("
        "'findnpropagate_torch.tools.extract_pseudo_labels')\n"
        "importlib.import_module("
        "'findnpropagate_torch.models.post_processing')\n"
        "importlib.import_module("
        "'findnpropagate_torch.models.backbones_image.maskclip')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('sklearn', 'jax', 'flax', 'findnpropagate_tpu')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# -------------------------------------------------------------- proposers

def test_gt_proposals_oracle():
    gt = np.zeros((5, 8), np.float32)
    gt[0] = [5, 0, 0, 4, 2, 1.5, 0.1, 3]
    gt[1] = [8, 1, 0, 1, 1, 1.7, 0.0, 9]
    gt[2] = [1, 1, 0, 1, 1, 1.0, 0.0, 11]           # beyond max_label
    got = talt.gt_proposals(gt)
    assert_same(got, jalt.gt_proposals(gt))
    assert got[2].tolist() == [3, 9] and (got[1] == 1.0).all()


# (proposer name in both registries, keyword arguments, scene arguments,
# the number of boxes the reference's own test expects, or None)
PROPOSER_CASES = [
    ("FrustumClusterProposer", {"topk": 1}, (0, 1, 0.4, 200), 1),
    ("FrustumClusterProposer", {"topk": 3}, (2, 2, 0.5, 300), None),
    ("FrustumDBSCAN", {"combine_clusters": True}, (1, 1, 0.45, 0), 1),
    ("FrustumDBSCAN", {"cluster_together": True}, (1, 2, 0.45, 100), None),
    ("FrustumDBSCAN", {}, (3, 2, 0.5, 300), None),
    ("FrustumOV3DET", {"min_points": 50}, (5, 1, 0.45, 0), 1),
    ("FrustumOV3DET", {"min_points": 50}, (6, 2, 0.5, 300), None),
    ("FrustumProposer", {"topk": 1, "min_cam_iou": 0.05, "bg_thr": 0.2},
     (7, 1, 0.5, 0), None),
    ("FrustumProposer", {"topk": 2, "min_cam_iou": 0.05, "bg_thr": 0.2},
     (8, 2, 0.5, 300), None),
]


@pytest.mark.parametrize("name,kw,args,count", PROPOSER_CASES)
def test_proposer_matches_reference(name, kw, args, count):
    pts, dets, labels, scores, cams, l2i = scene(*args)
    if name == "FrustumProposer":
        # both registries give the same object; the port's HDBSCAN tree on
        # the CPU here
        port = talt.ALT_PROPOSER_REGISTRY[name](CLASS_NAMES, device="cpu",
                                                **kw)
    else:
        port = talt.ALT_PROPOSER_REGISTRY[name](CLASS_NAMES, **kw)
    ref = jalt.ALT_PROPOSER_REGISTRY[name](CLASS_NAMES, **kw)
    want = ref.propose(pts, dets, labels, scores, cams, l2i)
    got = port.propose(pts, dets, labels, scores, cams, l2i)
    assert_same(got, want)
    if count is not None:
        assert len(got[0]) == count
        np.testing.assert_allclose(got[0][0, :2], BOXES3D[0, :2], atol=1.0)


def test_base_proposer_recovers_box_and_rejects_sheet():
    """The reference's FrustumProposerBase case: the box is recovered with
    the anchor's dims and the camera score; a flat sheet is background."""
    pts, dets, labels, scores, cams, l2i = scene(7, 1, 0.5)
    kw = dict(topk=1, min_cam_iou=0.05, bg_thr=0.2)
    port = talt.FrustumProposerBase(["car"] * 10, device="cpu", **kw)
    ref = jalt.FrustumProposerBase(["car"] * 10, **kw)
    boxes, sc, lab = port.propose(pts, dets, labels, scores, cams, l2i)
    box = BOXES3D[0]
    best = boxes[np.argmin(np.linalg.norm(boxes[:, :2] - box[:2], axis=1))]
    np.testing.assert_allclose(best[:2], box[:2], atol=1.5)
    np.testing.assert_allclose(best[3:6], port.anchors[0], atol=1e-5)
    assert (lab == 1).all() and np.allclose(sc, 0.9)
    rng = np.random.RandomState(7)
    sheet = np.concatenate(
        [pts[:, :2] + rng.uniform(-2, 2, (len(pts), 2)),
         np.full((len(pts), 1), box[2] - box[5] / 2)], 1).astype(np.float32)
    got = port.propose(sheet, dets, labels, scores, cams, l2i)
    assert_same(got, ref.propose(sheet, dets, labels, scores, cams, l2i))
    assert len(got[0]) == 0


def test_pca_bbox_matches_reference():
    rng = np.random.RandomState(3)
    local = rng.uniform(-0.5, 0.5, (500, 3)) * np.array([4.0, 1.8, 1.5])
    c, s = np.cos(0.6), np.sin(0.6)
    pts = np.stack([local[:, 0] * c - local[:, 1] * s + 10.0,
                    local[:, 0] * s + local[:, 1] * c - 3.0,
                    local[:, 2] + 0.5], -1)
    got = talt.compute_pca_bbox(pts)
    assert got == jalt.compute_pca_bbox(pts)
    assert abs(((got[6] - 0.6) + np.pi / 2) % np.pi - np.pi / 2) < 0.12


def clip2scene_scene(seed):
    rng = np.random.RandomState(seed)
    car = rng.uniform(-0.5, 0.5, (200, 3)) * [4, 2, 1.5] + [10, 0, 0]
    ped = rng.uniform(-0.5, 0.5, (80, 3)) * [0.6, 0.6, 1.7] + [5, 6, 0]
    road = rng.uniform(-20, 20, (300, 3)) * [1, 1, 0.01]
    points = np.concatenate([car, ped, road]).astype(np.float32)
    # CLIP2Scene labels: car 4, pedestrian 7, driveable_surface 11
    seg = np.concatenate([np.full(200, 4), np.full(80, 7),
                          np.full(300, 11)])
    seg[rng.uniform(size=len(seg)) < 0.05] = 9        # some trailer noise
    return points, seg


@pytest.mark.parametrize("name", ["CLIP2SceneProposer",
                                  "CLIP2SceneCCProposer"])
def test_clip2scene_matches_reference(name):
    points, seg = clip2scene_scene(7)
    kw = dict(eps=0.6, min_samples=10)
    got = talt.ALT_PROPOSER_REGISTRY[name](CLASS_NAMES, **kw).propose(
        points, seg)
    assert_same(got, jalt.ALT_PROPOSER_REGISTRY[name](
        CLASS_NAMES, **kw).propose(points, seg))
    if name == "CLIP2SceneProposer":
        found = {int(lb): b for lb, b in zip(got[2], got[0])}
        assert set(found) == {1, 9}
        np.testing.assert_allclose(found[1][:2], [10, 0], atol=0.5)


def test_registry_names_match_reference():
    assert list(talt.ALT_PROPOSER_REGISTRY) == list(
        jalt.ALT_PROPOSER_REGISTRY)
    assert talt.ALT_PROPOSER_REGISTRY["CLIP2SceneCCProposer"](
        ["car"]).cluster_together
