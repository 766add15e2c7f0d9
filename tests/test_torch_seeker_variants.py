"""PyTorch port of the seeker's variants and inputs against the JAX
package, CPU, small sizes: the KITTI seeker (against FrustumProposerOGKITTI
and the numpy loop oracle of tests/test_seeker_kitti_parity.py), the SEG
seeker (PointNetInstanceSeg logits with the flax weights carried across,
its foreground masks and propose), `from_config` on the repo's three
seeker yamls, and the cached-detection loaders on small COCO files.

Tolerances: boxes and oracle scores 1e-4 against JAX (f32 rounding in
another order); logits 1e-4; the loop oracle's own (its oracle score and
the picked slot 2e-3, 5e-3 from an oracle slot); masks, labels and the
loaders' arrays exactly.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.config import cfg_from_yaml_file
from findnpropagate_torch.models.frustum_pointnets import PointNetInstanceSeg
from findnpropagate_torch.openvocab import preprocessed_detector as TP
from findnpropagate_torch.openvocab.frustum_proposer import FrustumProposerOG
from findnpropagate_torch.openvocab.frustum_proposer_kitti import (
    FrustumProposerOGKITTI,
    img_to_lidar_kitti,
    lidar_to_img_kitti,
)
from findnpropagate_torch.openvocab.frustum_proposer_seg import (
    LABEL_TO_HIERARCHY,
    FrustumProposerSEG,
)
from findnpropagate_torch.utils.weights import from_jax_variables
from findnpropagate_tpu import config as jcfg
from findnpropagate_tpu.models.frustum_pointnets import (
    PointNetInstanceSeg as JaxSegNet,
)
from findnpropagate_tpu.openvocab import frustum_proposer as JF
from findnpropagate_tpu.openvocab import frustum_proposer_kitti as JK
from findnpropagate_tpu.openvocab import frustum_proposer_seg as JS
from findnpropagate_tpu.openvocab import preprocessed_detector as JP
from test_frustum_proposer import CLASS_NAMES
from test_frustum_proposer_seg import _one_box_scene
from test_seeker_kitti_parity import (
    kitti_seeker_oracle,
    make_kitti_calib,
    make_scene,
    project_box_to_det,
)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_mags=2, num_sizes=2, num_rotations=2, ry_max=1.5)
SEEKER_YAMLS = (
    "tools/cfgs/nuscenes_models/nuscenes_box_seeker_proposals.yaml",
    "tools/cfgs/nuscenes_box_seeker_proposals.yaml",
    "tools/cfgs/kitti_models/kitti_box_seeker_proposals.yaml")


def tt(a):
    return torch.from_numpy(np.asarray(a))


def as_np(out):
    return type(out)(*(np.asarray(t) for t in out))


def assert_same_output(got, ref, atol=1e-4):
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.scores, ref.scores)
    v = ref.valid
    np.testing.assert_allclose(got.boxes[v], ref.boxes[v], atol=atol)
    np.testing.assert_allclose(got.oracle[v], ref.oracle[v], atol=atol)


# ------------------------------------------------------------------ KITTI

KITTI_OBJS = [(np.array([18.0, 3.0, -0.8, 3.9, 1.6, 1.56, 0.25]), 1),
              (np.array([11.0, -3.5, -0.6, 0.8, 0.6, 1.73, 0.0]), 7),
              (np.array([30.0, -6.0, -0.7, 3.9, 1.6, 1.56, 1.2]), 1)]


def kitti_inputs(seed=11):
    P2, R0, V2C = (a.astype(np.float32) for a in make_kitti_calib())
    rng = np.random.RandomState(seed)
    points = make_scene(rng, KITTI_OBJS).astype(np.float32)
    db = np.zeros((6, 4), np.float32)
    for i, (b, _) in enumerate(KITTI_OBJS):
        db[i] = project_box_to_det(b, *make_kitti_calib())
    db[3] = db[0] + 2.0                            # 2D NMS duplicate
    db[4] = [5.0, 5.0, 30.0, 30.0]                 # no point behind it
    return (points, np.ones(len(points), bool), db,
            np.array([1, 7, 1, 1, 3, 1], np.int32),
            np.array([.9, .8, .9, .6, .5, .0], np.float32),
            np.array([1, 1, 1, 1, 1, 0], bool), P2, R0, V2C)


def test_kitti_calibration_roundtrip_matches_jax():
    P2, R0, V2C = (a.astype(np.float32) for a in make_kitti_calib())
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(4, 60, 200), rng.uniform(-15, 15, 200),
                    rng.uniform(-2, 1, 200)], -1).astype(np.float32)
    ref_uv, ref_d = JK.lidar_to_img_kitti(jnp.asarray(pts), *map(
        jnp.asarray, (P2, R0, V2C)))
    uv, d = lidar_to_img_kitti(tt(pts), tt(P2), tt(R0), tt(V2C))
    np.testing.assert_allclose(uv.numpy(), np.asarray(ref_uv), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-4)
    uvd = np.concatenate([uv.numpy(), d.numpy()[:, None]], 1)
    back = img_to_lidar_kitti(tt(uvd), tt(P2), tt(R0), tt(V2C)).numpy()
    np.testing.assert_allclose(back, np.asarray(JK.img_to_lidar_kitti(
        jnp.asarray(uvd), *map(jnp.asarray, (P2, R0, V2C)))), atol=1e-4)
    np.testing.assert_allclose(back, pts, atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"search_depth": 8.0,
                                     "clamp_bottom": 1.0, "topk": 2}],
                         ids=["default", "search_depth_clamp_top2"])
def test_kitti_propose_matches_jax(kw):
    args = kitti_inputs()
    ref = JK.FrustumProposerOGKITTI(**SMALL, **kw).propose(
        *map(jnp.asarray, args))
    got = FrustumProposerOGKITTI(**SMALL, **kw).propose(*args, device="cpu")
    ref = jax.tree.map(np.asarray, ref)
    assert ref.valid.sum() >= 3
    assert_same_output(as_np(got), ref)


@pytest.mark.parametrize("kw,seed", [({}, 11),
                                     ({"search_depth": 8.0,
                                       "clamp_bottom": 1.0}, 5)])
def test_kitti_propose_matches_loop_oracle(kw, seed):
    """The default config against kitti_seeker_oracle, as
    tests/test_seeker_kitti_parity.py::check_parity holds the JAX seeker:
    the oracle score within 2e-3 of the best, and the pick one of the
    oracle's slots (within 5e-3) whose score ties the best within 2e-3."""
    cfg = FrustumProposerOGKITTI(**kw)
    P2, R0, V2C = make_kitti_calib()
    points = make_scene(np.random.RandomState(seed), KITTI_OBJS[:2])
    dets = [(project_box_to_det(b, P2, R0, V2C), lb)
            for b, lb in KITTI_OBJS[:2]]
    out = cfg.propose(
        points.astype(np.float32), np.ones(len(points), bool),
        np.stack([db for db, _ in dets]).astype(np.float32),
        np.array([lb for _, lb in dets], np.int32),
        np.full(len(dets), 0.9, np.float32), np.ones(len(dets), bool),
        P2.astype(np.float32), R0.astype(np.float32),
        V2C.astype(np.float32), device="cpu")
    for i, (db, lb) in enumerate(dets):
        w = kitti_seeker_oracle(cfg, points, db, lb, P2, R0, V2C)
        assert w is not None and bool(out.valid[i])
        _, ws, props, scores = w
        assert abs(float(out.oracle[i]) - ws) < 2e-3
        d = np.linalg.norm(props - out.boxes[i].numpy()[None], axis=1)
        j = int(np.argmin(d))
        assert d[j] < 5e-3 and scores[j] > ws - 2e-3


# -------------------------------------------------------------------- SEG

def seg_nets(rng, k=128):
    """A flax PointNetInstanceSeg tree (batch statistics drawn: means
    N(0, 0.1^2), variances in [0.5, 1.5]) and the port's module carrying
    the same weights."""
    net = JaxSegNet(n_classes=6)
    var = jax.tree.map(np.asarray, net.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, k, 3)),
        jnp.zeros((1, 6)), jnp.ones((1, k), bool), False))
    var["batch_stats"] = {
        name: {"mean": 0.1 * rng.randn(*bn["mean"].shape).astype(np.float32),
               "var": rng.uniform(0.5, 1.5, bn["var"].shape).astype(
                   np.float32)}
        for name, bn in var["batch_stats"].items()}
    port = PointNetInstanceSeg(6).eval()
    from_jax_variables(var, port)
    return net, var, port


def test_pointnet_seg_logits_match_flax():
    rng = np.random.RandomState(0)
    net, var, port = seg_nets(rng, k=40)
    pts = rng.randn(3, 40, 3).astype(np.float32)
    one_hot = np.eye(6, dtype=np.float32)[[0, 2, 5]]
    valid = rng.rand(3, 40) > 0.3
    ref = np.asarray(net.apply(var, jnp.asarray(pts), jnp.asarray(one_hot),
                               jnp.asarray(valid), False))
    with torch.no_grad():
        got = port(tt(pts), tt(one_hot), tt(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(ref).max() > 1e-2


def seg_scene():
    (l2i, c2l, intr, _, pts, pmask, det_boxes, det_labels, det_scores,
     det_cams, det_mask) = _one_box_scene(np.random.RandomState(0))
    det_boxes[1] = det_boxes[0] + 5.0              # a second filtered det
    det_labels[1], det_scores[1], det_mask[1] = 9, 0.7, True
    return (pts, pmask, det_boxes, det_labels, det_scores, det_cams,
            det_mask, l2i[None].astype(np.float32),
            c2l[None].astype(np.float32), intr[None].astype(np.float32))


def centre_seg_head(var, port, args):
    """Random weights give every point of a frustum nearly the same logits
    (the global feature dominates), so the filter would keep all or none.
    Make logit 0 zero and move logit 1's bias to the median over the first
    detection's points: about half of them become foreground. Updates the
    flax tree and the port's module alike."""
    seen = []
    seg = FrustumProposerSEG(CLASS_NAMES, seg_params=port.state_dict(),
                             seg_pts_thr=50, max_seg_points=128)
    seg.seg_net.register_forward_hook(
        lambda mod, inp, out: seen.append((out.detach(), inp[2])))
    seg.seg_point_masks(*args[:4], args[5], args[6], args[7], device="cpu")
    logits, valid = seen[0]
    kernel = np.array(var["params"]["seg_out"]["kernel"])
    bias = np.array(var["params"]["seg_out"]["bias"])
    kernel[:, 0] = 0.0
    bias[0] = 0.0
    bias[1] -= float(np.median(logits[0, valid[0], 1].numpy()))
    var["params"]["seg_out"] = {"kernel": kernel, "bias": bias}
    from_jax_variables(var, port)


def test_seg_point_masks_and_propose_match_jax():
    rng = np.random.RandomState(1)
    _, var, port = seg_nets(rng)
    args = seg_scene()
    centre_seg_head(var, port, args)
    kw = dict(seg_pts_thr=50, max_seg_points=128, **SMALL)
    jx = JS.FrustumProposerSEG(CLASS_NAMES, seg_params=var, **kw)
    pt = FrustumProposerSEG(CLASS_NAMES, seg_params=port.state_dict(), **kw)
    jargs = [jnp.asarray(a) for a in args]
    ref_m = np.asarray(jx.seg_point_masks(var, *jargs[:4], jargs[5],
                                          jargs[6], jargs[7]))
    got_m = pt.seg_point_masks(*args[:4], args[5], args[6], args[7],
                               device="cpu").numpy()
    np.testing.assert_array_equal(got_m, ref_m)
    assert 0 < ref_m[0].sum() < 128 and ref_m[2:].all()  # filtered, passed
    ref = jax.tree.map(np.asarray, jx.propose(*jargs))
    got = as_np(pt.propose(*args, device="cpu"))
    assert ref.valid[0]
    assert_same_output(got, ref)
    # no weights: the filter is off and SEG equals OG
    og = as_np(FrustumProposerOG(class_names=CLASS_NAMES, **SMALL).propose(
        *args, device="cpu"))
    off = as_np(FrustumProposerSEG(CLASS_NAMES, **SMALL).propose(
        *args, device="cpu"))
    for a, b in zip(og, off):
        np.testing.assert_array_equal(a, b)


def test_label_to_hierarchy():
    assert LABEL_TO_HIERARCHY == JS.LABEL_TO_HIERARCHY


# ------------------------------------------------------------ from_config

def dataclass_fields(obj, cls):
    return {f: getattr(obj, f) for f in cls.__dataclass_fields__}


@pytest.mark.parametrize("yaml_path", SEEKER_YAMLS)
def test_from_config_field_by_field(yaml_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = cfg_from_yaml_file(yaml_path)
    jc = jcfg.cfg_from_yaml_file(yaml_path, jcfg.EDict())
    head, jhead = cfg.MODEL.DENSE_HEAD, jc.MODEL.DENSE_HEAD
    if head.NAME == "FrustumProposerOGKITTI":
        pairs = [(FrustumProposerOGKITTI.from_config(head, cfg.CLASS_NAMES),
                  JK.FrustumProposerOGKITTI.from_config(jhead,
                                                        jc.CLASS_NAMES))]
    else:
        seg_head = dict(head, PARAMS=dict(head.PARAMS, seg_thr=0.4,
                                          seg_pts_thr=30,
                                          max_seg_points=256))
        t_seg = FrustumProposerSEG.from_config(seg_head, cfg.CLASS_NAMES)
        j_seg = JS.FrustumProposerSEG.from_config(
            dict(jhead, PARAMS=dict(jhead.PARAMS, seg_thr=0.4,
                                    seg_pts_thr=30, max_seg_points=256)),
            jc.CLASS_NAMES)
        for f in ("seg_thr", "seg_pts_thr", "max_seg_points",
                  "n_seg_classes"):
            assert getattr(t_seg, f) == getattr(j_seg, f), f
        pairs = [(FrustumProposerOG.from_config(head, cfg.CLASS_NAMES),
                  JF.FrustumProposerOG.from_config(jhead, jc.CLASS_NAMES)),
                 (t_seg.og, j_seg.og)]
    for got, ref in pairs:
        want = dataclass_fields(ref, type(ref))
        assert set(want) == set(type(got).__dataclass_fields__)
        assert dataclass_fields(got, type(ref)) == want
        np.testing.assert_array_equal(got.base_boxes(), ref.base_boxes())


# ---------------------------------------------------------------- loaders

def write_coco(tmp_path, rng):
    cats = [{"id": 1, "name": "car"}, {"id": 2, "name": "pedestrian"},
            {"id": 3, "name": "not_a_class"}]
    paths, image_paths = [], []
    for cam, name in enumerate(TP.CAMERA_NAMES):
        fname = f"samples/{name}/frame0__{name}__1533.jpg"
        image_paths.append(fname)
        anns = []
        for j in range(cam + 2):
            a = {"image_id": 7, "category_id": int(rng.randint(1, 4)),
                 "bbox": [float(x) for x in rng.uniform(0, 500, 4)]}
            if j % 2:
                a["score"] = float(rng.choice([0.3, 0.6, 0.6]))
            anns.append(a)
        data = {"images": [{"id": 7, "file_name": fname}],
                "categories": cats,
                ("annotations" if cam % 2 else "predictions"): anns}
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(data))
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.json"))
    n_known = sum(len(json.loads(Path(p).read_text()).get(
        "annotations", json.loads(Path(p).read_text()).get("predictions")))
        for p in paths[:-1])
    return paths, image_paths, n_known


@pytest.mark.parametrize("box_fmt,max_dets", [("xywh", 64), ("xyxy", 5)])
def test_preprocessed_detector_matches_jax(tmp_path, box_fmt, max_dets):
    paths, image_paths, n_anns = write_coco(tmp_path,
                                            np.random.RandomState(0))
    names = ["car", "pedestrian"]
    got = TP.PreprocessedDetector(paths, names, box_fmt, max_dets)
    ref = JP.PreprocessedDetector(paths, names, box_fmt, max_dets)
    for a, b in ((got.infer(image_paths), ref.infer(image_paths)),
                 (got.infer_kitti("frame0__CAM_FRONT__1533"),
                  ref.infer_kitti("frame0__CAM_FRONT__1533")),
                 (got.infer(["nothing.jpg"]), ref.infer(["nothing.jpg"]))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    n = got.infer(image_paths)["det_mask"].sum()
    assert 0 < n <= min(max_dets, n_anns) and (max_dets > 5 or n == 5)
    assert TP.IMAGE_ORDER == JP.IMAGE_ORDER
    assert TP.CAMERA_NAMES == JP.CAMERA_NAMES


def test_pad_detections_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.uniform(0, 100, (9, 4)).astype(np.float32)
    labels, cams = rng.randint(1, 5, 9), rng.randint(0, 6, 9)
    scores = rng.uniform(0, 1, 9)
    for d in (4, 9, 16):
        a = TP.pad_detections(boxes, labels, scores, cams, d)
        b = JP.pad_detections(boxes, labels, scores, cams, d)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    e = TP.pad_detections([], [], [], [], 3)
    assert not e["det_mask"].any() and e["det_boxes"].shape == (3, 4)


def test_preprocessed_glip_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    preds = {i: {"boxes": torch.from_numpy(
        rng.uniform(0, 300, (i + 1, 4)).astype(np.float32)),
        "labels": torch.arange(1, i + 2), "scores": torch.from_numpy(
            rng.uniform(0, 1, i + 1).astype(np.float32))} for i in range(3)}
    torch.save(preds, tmp_path / "glip.pth")
    image_paths = [f"samples/CAM_{c}/img{c}.jpg" for c in range(6)]
    meta = {"images": [{"id": c % 4, "file_name": p}
                       for c, p in enumerate(image_paths)]}
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    args = (tmp_path / "glip.pth", tmp_path / "meta.json", ["a", "b"], 8)
    a = TP.PreprocessedGLIP(*args).infer(image_paths)
    b = JP.PreprocessedGLIP(*args).infer(image_paths)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["det_mask"].sum() == 8
