"""The port's host data layer (findnpropagate_torch/datasets/, utils/
geometry_np.py, native/) against the JAX package's, on the same inputs and
seeds: the reference draws from numpy's global state after
``np.random.seed(s)``, the port from the dataset's ``RandomState(s)``.
Everything is numpy (or the same C++ source built the same way), so every
comparison is bit for bit."""

import pickle

import numpy as np
import pytest

import findnpropagate_tpu.datasets as JD
from findnpropagate_torch import datasets as TD
from findnpropagate_torch import native as tnative
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.augmentor import database_sampler as tdb
from findnpropagate_torch.datasets.augmentor.data_augmentor import (
    DataAugmentor as TAug,
)
from findnpropagate_torch.datasets.processor.data_processor import (
    DataProcessor as TProc,
)
from findnpropagate_torch.datasets.processor.point_feature_encoder import (
    PointFeatureEncoder as TEnc,
)
from findnpropagate_torch.datasets.synthetic import SyntheticDataset as TSyn
from findnpropagate_torch.utils import geometry_np as TG
from findnpropagate_tpu import native as jnative
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets.augmentor import database_sampler as jdb
from findnpropagate_tpu.datasets.augmentor.data_augmentor import (
    DataAugmentor as JAug,
)
from findnpropagate_tpu.datasets.processor.data_processor import (
    DataProcessor as JProc,
)
from findnpropagate_tpu.datasets.processor.point_feature_encoder import (
    PointFeatureEncoder as JEnc,
)
from findnpropagate_tpu.datasets.synthetic import SyntheticDataset as JSyn
from findnpropagate_tpu.utils import geometry_np as JG

CLASSES = ["Car", "Pedestrian", "Cyclist"]


def assert_same(a, b, path="out"):
    """Equal structure, and equal values and dtypes, bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                            b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def make_scene(seed=0, n_pseudo=2):
    """Three boxes with points inside, background points (some beyond
    40 m) and pseudo boxes of 8 columns."""
    rng = np.random.RandomState(seed)
    boxes = np.array([[10.0, 0.0, 0.0, 4.0, 2.0, 1.5, 0.3],
                      [-6.0, 5.0, -0.2, 1.8, 0.8, 1.7, -1.2],
                      [3.0, -8.0, 0.1, 0.8, 0.7, 1.7, 2.5]], np.float32)
    pts = []
    for b in boxes:
        local = rng.uniform(-0.45, 0.45, (150, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        pts.append(np.stack([local[:, 0] * c - local[:, 1] * s,
                             local[:, 0] * s + local[:, 1] * c,
                             local[:, 2]], -1) + b[:3])
    bg = rng.uniform(-20, 20, (300, 3))
    bg[:, 2] = rng.uniform(-2, 2, 300)
    far = rng.uniform(-55, 55, (60, 3))
    far[:, 2] = rng.uniform(-2, 2, 60)
    points = np.concatenate(pts + [bg, far]).astype(np.float32)
    inten = rng.uniform(0, 1, (len(points), 1)).astype(np.float32)
    pseudo = np.zeros((n_pseudo, 8), np.float32)
    pseudo[:, :3] = rng.uniform(-15, 15, (n_pseudo, 3))
    pseudo[:, 3:6] = [0.8, 0.7, 1.7]
    pseudo[:, 6] = rng.uniform(-np.pi, np.pi, n_pseudo)
    pseudo[:, 7] = 2
    return {"points": np.concatenate([points, inten], 1),
            "gt_boxes": boxes, "gt_names": np.asarray(CLASSES),
            "pseudo_boxes": pseudo, "frame_id": 3}


def copy_scene(d):
    return {k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
            for k, v in d.items()}


# ------------------------------------------------------------ geometry

def _boxes(rng, n, cols=7):
    b = np.zeros((n, cols), np.float32)
    b[:, :2] = rng.uniform(-6, 6, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    if cols > 7:
        b[:, 7:] = rng.uniform(-2, 2, (n, cols - 7))
    return b


GEOMETRY = {
    "limit_period": lambda G, r: G.limit_period(
        r.uniform(-10, 10, 50), offset=0.5, period=2 * np.pi),
    "rotate_points_along_z": lambda G, r: G.rotate_points_along_z(
        r.uniform(-9, 9, (40, 4)).astype(np.float32), 0.7),
    "rotate_boxes_along_z_7": lambda G, r: G.rotate_boxes_along_z(
        _boxes(r, 9), -1.1),
    "rotate_boxes_along_z_9": lambda G, r: G.rotate_boxes_along_z(
        _boxes(r, 9, 9), 2.3),
    "flip_along_x": lambda G, r: G.flip_along_x(
        r.uniform(-9, 9, (40, 4)).astype(np.float32), _boxes(r, 5, 9)),
    "flip_along_y": lambda G, r: G.flip_along_y(
        r.uniform(-9, 9, (40, 4)).astype(np.float32), _boxes(r, 5, 9)),
    "mask_points_by_range": lambda G, r: G.mask_points_by_range(
        r.uniform(-9, 9, (80, 3)), [-5, -5, -3, 5, 5, 1]),
    "mask_boxes_outside_range": lambda G, r: G.mask_boxes_outside_range(
        _boxes(r, 30), [-5, -5, -3, 5, 5, 1]),
    "boxes_to_corners_3d": lambda G, r: G.boxes_to_corners_3d(_boxes(r, 7)),
    "boxes_to_corners_bev": lambda G, r: G.boxes_to_corners_bev(
        _boxes(r, 7)),
    "points_in_boxes_mask": lambda G, r: G.points_in_boxes_mask(
        r.uniform(-7, 7, (300, 3)).astype(np.float32), _boxes(r, 6)),
    "boxes_bev_iou_cpu": lambda G, r: G.boxes_bev_iou_cpu(
        _boxes(r, 12), _boxes(r, 15)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_np_matches_jax(name):
    fn = GEOMETRY[name]
    assert_same(fn(TG, np.random.RandomState(0)),
                fn(JG, np.random.RandomState(0)))


def test_bev_iou_native_against_plain():
    """The native IoU against the numpy polygon clip (rounding of two
    float64 clips in another order: 1e-6), including disjoint, nested,
    touching and identical boxes."""
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    b[:5] = a[:5]
    b[5, :] = a[6]
    b[5, 3:5] *= 0.5
    b[6, :] = a[7] + [50, 0, 0, 0, 0, 0, 0]
    got = TG.boxes_bev_iou_cpu(a, b)
    want = TG.boxes_bev_iou_plain(a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (np.diag(got[:5, :5]) > 1 - 1e-6).all() and (got > 0).sum() > 10
    assert TG.boxes_bev_iou_cpu(a[:0], b).shape == (0, 30)


NATIVE = {
    "rotated_iou_bev": lambda N, r: N.rotated_iou_bev(
        _boxes(r, 10)[:, [0, 1, 3, 4, 6]], _boxes(r, 12)[:, [0, 1, 3, 4, 6]]),
    "iou_bev7": lambda N, r: N.iou_bev7(_boxes(r, 10), _boxes(r, 12)),
    "iou3d": lambda N, r: N.iou3d(_boxes(r, 10), _boxes(r, 12)),
    "points_in_boxes": lambda N, r: N.points_in_boxes(
        r.uniform(-7, 7, (500, 3)), _boxes(r, 8)),
    "nms_bev": lambda N, r: N.nms_bev(_boxes(r, 30), r.uniform(0, 1, 30),
                                      0.1),
}


@pytest.mark.parametrize("name", sorted(NATIVE))
def test_native_matches_jax_native(name):
    """The port's build of its copy of geometry.cc against the JAX
    package's library, call for call."""
    assert jnative.available()
    fn = NATIVE[name]
    assert_same(fn(tnative, np.random.RandomState(1)),
                fn(jnative, np.random.RandomState(1)))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails makes every call raise."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-g++"))
    a = _boxes(np.random.RandomState(0), 3)
    with pytest.raises(RuntimeError, match="geometry.cc"):
        TG.boxes_bev_iou_cpu(a, a)
    bad = tmp_path / "false.sh"
    bad.write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setattr(tnative, "CXX", str(bad))
    with pytest.raises(RuntimeError, match="broken"):
        tnative.iou3d(a, a)
    assert not list((tmp_path / "native").glob("*"))


# ------------------------------------------------------------ augmentor

AUGS = [
    # tests/test_augmentor_local.py's settings
    ("random_local_translation", {"LOCAL_TRANSLATION_RANGE": [0.5, 0.5],
                                  "ALONG_AXIS_LIST": ["x"]}, 1),
    ("random_local_translation", {"LOCAL_TRANSLATION_RANGE": [-0.5, 0.5],
                                  "ALONG_AXIS_LIST": ["x", "y", "z"]}, 1),
    ("random_local_scaling", {"LOCAL_SCALE_RANGE": [1.2, 1.2]}, 2),
    ("random_local_scaling", {"LOCAL_SCALE_RANGE": [0.9, 1.1]}, 2),
    ("random_local_rotation", {"LOCAL_ROT_ANGLE": [0.5, 0.5]}, 2),
    ("random_local_rotation", {"LOCAL_ROT_ANGLE": [-0.4, 0.4]}, 2),
    ("random_global_frustum_dropout", {"INTENSITY_RANGE": [0.3, 0.3],
                                       "DIRECTION": ["top"]}, 3),
    ("random_world_frustum_dropout", {"INTENSITY_RANGE": [0.0, 0.2],
                                      "DIRECTION": ["top", "bottom", "left",
                                                    "right"]}, 3),
    ("random_local_frustum_dropout", {"INTENSITY_RANGE": [0.5, 0.5],
                                      "DIRECTION": ["top"]}, 4),
    ("random_local_frustum_dropout", {"INTENSITY_RANGE": [0.1, 0.6],
                                      "DIRECTION": ["top", "bottom", "left",
                                                    "right"]}, 4),
    ("random_local_pyramid_aug", {"DROP_PROB": 1.0, "SPARSIFY_PROB": 0.0,
                                  "SWAP_PROB": 0.0}, 5),
    ("random_local_pyramid_aug", {"DROP_PROB": 0.0, "SPARSIFY_PROB": 1.0,
                                  "SPARSIFY_MAX_NUM": 5, "SWAP_PROB": 0.0},
     5),
    ("random_local_pyramid_aug", {"DROP_PROB": 0.3, "SPARSIFY_PROB": 0.5,
                                  "SPARSIFY_MAX_NUM": 5, "SWAP_PROB": 1.0,
                                  "SWAP_MAX_NUM": 20}, 6),
    # the ST yaml's (tools/cfgs/nuscenes_models/transfusion_lidar_st.yaml)
    ("random_world_flip", {"ALONG_AXIS_LIST": ["x", "y"]}, 7),
    ("random_world_rotation", {"WORLD_ROT_ANGLE": [-0.78539816,
                                                   0.78539816]}, 8),
    ("random_world_scaling", {"WORLD_SCALE_RANGE": [0.9, 1.1]}, 9),
    ("random_world_translation", {"NOISE_TRANSLATE_STD": [0.5, 0.5, 0.5]},
     10),
]


@pytest.mark.parametrize("name,cfg,seed", AUGS,
                         ids=[f"{a[0]}-{i}" for i, a in enumerate(AUGS)])
def test_augmentation_matches_jax(name, cfg, seed):
    """One augmentation through each package's DataAugmentor.forward (its
    queue, the limit_period and gt_boxes_mask tail), the draws seeded
    alike; the recorded parameters and the pseudo boxes included."""
    conf = {"AUG_CONFIG_LIST": [dict(cfg, NAME=name)]}
    d = make_scene()
    d["gt_boxes_mask"] = np.array([True, False, True])
    np.random.seed(seed)
    want = JAug(conf, CLASSES).forward(copy_scene(d))
    got = TAug(conf, CLASSES, rng=np.random.RandomState(seed)).forward(
        copy_scene(d))
    assert_same(got, want)


def test_augmentor_refuses_unknown_step():
    with pytest.raises(ValueError, match="load_frustum_pseudos"):
        TAug({"AUG_CONFIG_LIST": [{"NAME": "load_frustum_pseudos"}]},
             CLASSES)


# ------------------------------------------------------------ processor

PROCESSORS = [
    ([{"NAME": "mask_points_and_boxes_outside_range",
       "REMOVE_OUTSIDE_BOXES": True},
      {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True,
                                                     "test": False}},
      {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.2, 0.2, 0.2]}],
     True),
    ([{"NAME": "mask_points_and_boxes_outside_range",
       "REMOVE_OUTSIDE_BOXES": True},
      {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True,
                                                     "test": False}}],
     False),
    # near-only sampling: fewer than NUM_POINTS points lie beyond 40 m
    ([{"NAME": "sample_points", "NUM_POINTS": {"train": 500, "test": 400}},
      {"NAME": "shuffle_points"}], True),
    # more than NUM_POINTS points beyond 40 m
    ([{"NAME": "sample_points", "NUM_POINTS": {"train": 30, "test": 20}}],
     False),
]


@pytest.mark.parametrize("steps,training", PROCESSORS)
def test_processor_matches_jax(steps, training):
    pcr = [-12.0, -12.0, -3.0, 12.0, 12.0, 1.0]
    d = make_scene()
    np.random.seed(11)
    want = JProc(steps, pcr, training, 4).forward(copy_scene(d))
    tp = TProc(steps, pcr, training, 4, rng=np.random.RandomState(11))
    got = tp.forward(copy_scene(d))
    assert_same(got, want)
    jp = JProc(steps, pcr, training, 4)
    assert_same([tp.grid_size, tp.voxel_size, tp.double_flip],
                [jp.grid_size, jp.voxel_size, jp.double_flip])


def test_point_feature_encoder_matches_jax():
    cfg = {"encoding_type": "absolute_coordinates_encoding",
           "used_feature_list": ["x", "y", "z", "time"],
           "src_feature_list": ["x", "y", "z", "intensity", "time"]}
    rng = np.random.RandomState(0)
    d = {"points": rng.uniform(-5, 5, (50, 5)).astype(np.float32)}
    got, want = TEnc(cfg), JEnc(cfg)
    assert got.num_point_features == want.num_point_features == 4
    assert_same(got.forward(dict(d)), want.forward(dict(d)))


# ------------------------------------------------------------ dataset

def data_cfg(pattern="uniform", augs=True, camera=True, double_flip=False,
             scenes=4):
    cfg = {
        "DATASET": "SyntheticDataset",
        "POINT_CLOUD_RANGE": [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0],
        "SYNTHETIC": {"NUM_SCENES": scenes, "NUM_OBJECTS": 6,
                      "NUM_RAW_POINTS": 3000, "PATTERN": pattern},
        "CAPACITIES": {"MAX_POINTS": 5000, "MAX_GT": 16, "MAX_PSEUDO": 6,
                       "MAX_VOXELS": 4000, "MAX_POINTS_PER_VOXEL": 8},
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z", "intensity"],
            "src_feature_list": ["x", "y", "z", "intensity"]},
        "DATA_PROCESSOR": [
            {"NAME": "mask_points_and_boxes_outside_range",
             "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "shuffle_points",
             "SHUFFLE_ENABLED": {"train": True, "test": False}},
            {"NAME": "transform_points_to_voxels",
             "VOXEL_SIZE": [0.2, 0.2, 0.1], "DOUBLE_FLIP": double_flip}],
    }
    if camera:
        cfg["SYNTHETIC"]["CAMERA"] = {"NUM": 2, "IMAGE_SIZE": [8, 12]}
    if augs:
        cfg["DATA_AUGMENTOR"] = {"AUG_CONFIG_LIST": [
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_world_rotation",
             "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
            {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.9, 1.1]},
            {"NAME": "random_world_translation",
             "NOISE_TRANSLATE_STD": [0.5, 0.5, 0.5]}]}
    return cfg


@pytest.mark.parametrize("pattern", ["uniform", "lidar_ring"])
def test_synthetic_scenes_match_jax(pattern):
    """generate_scene of both packages, with the camera rig, in training
    and inference (different seeds)."""
    for training in (True, False):
        t = TSyn(EDict(data_cfg(pattern)), CLASSES, training=training)
        j = JSyn(JEDict(data_cfg(pattern)), CLASSES, training=training)
        for i in range(2):
            assert_same(t.generate_scene(i), j.generate_scene(i))
    assert TSyn(EDict(data_cfg()), CLASSES).pattern == "uniform"


def test_prepare_and_collate_match_jax():
    """prepare_data with the world augmentations (training), then
    collate_batch with pseudo boxes on some samples, roi keys and the
    camera matrices."""
    cfg = data_cfg()
    np.random.seed(5)
    j = JSyn(JEDict(cfg), CLASSES, training=True)
    want = [j[i] for i in range(3)]
    t = TSyn(EDict(cfg), CLASSES, training=True,
             rng=np.random.RandomState(5))
    got = [t[i] for i in range(3)]
    assert_same(got, want)
    rng = np.random.RandomState(1)
    for k, (a, b) in enumerate(zip(got, want)):
        if k < 2:
            p = rng.uniform(-5, 5, (4 + k, 8)).astype(np.float32)
            m = np.arange(4 + k) % 2 == 0
            a["pseudo_boxes"], b["pseudo_boxes"] = p, p.copy()
            a["pseudo_samples_mask"], b["pseudo_samples_mask"] = m, m.copy()
        roi = rng.uniform(0, 1, (5, 7)).astype(np.float32)
        a["roi_boxes"], b["roi_boxes"] = roi, roi.copy()
    batch = t.collate_batch(got)
    assert_same(batch, j.collate_batch(want))
    assert batch["pseudo_boxes"].shape == (3, 6, 8)
    assert batch["lidar2image"].shape == (3, 2, 4, 4)


def test_collate_double_flip_matches_jax():
    cfg = data_cfg(augs=False, double_flip=True)
    t = TSyn(EDict(cfg), CLASSES, training=False)
    j = JSyn(JEDict(cfg), CLASSES, training=False)
    assert t.data_processor.double_flip
    batch = t.collate_batch([t[0], t[1]])
    assert batch["batch_size"] == 8
    assert_same(batch, j.collate_batch([j[0], j[1]]))


def test_resample_on_empty_ground_truth_matches_jax():
    """A training sample whose boxes are all filtered out is replaced by
    a random other index, drawn from the dataset's rng."""

    def empty_even(cls):
        class Sparse(cls):
            def generate_scene(self, index):
                d = super().generate_scene(index)
                if index % 2 == 0:
                    d["gt_boxes"] = d["gt_boxes"][:0]
                    d["gt_names"] = d["gt_names"][:0]
                return d
        return Sparse

    cfg = data_cfg(scenes=6)
    np.random.seed(2)
    j = empty_even(JSyn)(JEDict(cfg), CLASSES, training=True)
    want = [j[i] for i in (0, 2, 4)]
    t = empty_even(TSyn)(EDict(cfg), CLASSES, training=True,
                         rng=np.random.RandomState(2))
    got = [t[i] for i in (0, 2, 4)]
    assert_same(got, want)
    assert all(g["frame_id"] % 2 == 1 for g in got)


def _jax_batches(cfg, epochs, seed, **kw):
    np.random.seed(seed)
    _, loader, _ = JD.build_dataloader(JEDict(cfg), CLASSES, batch_size=2,
                                       training=True, seed=seed, prefetch=0,
                                       **kw)
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out.extend(loader)
    return out


def _port_batches(cfg, epochs, seed, prefetch=0, **kw):
    _, loader, _ = TD.build_dataloader(EDict(cfg), CLASSES, batch_size=2,
                                       training=True, seed=seed,
                                       prefetch=prefetch, **kw)
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out.extend(loader)
    return out


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_build_dataloader_matches_jax(shard):
    """Two shuffled epochs of augmented batches (and one shard of two);
    the prefetching loader gives the same batches, its thread drawing."""
    cfg = data_cfg(scenes=5)
    kw = {} if shard is None else {"shard_id": shard[0],
                                   "num_shards": shard[1]}
    want = _jax_batches(cfg, 2, 3, **kw)
    got = _port_batches(cfg, 2, 3, **kw)
    assert len(got) == (4 if shard is None else 2)
    assert_same(got, want)
    assert_same(_port_batches(cfg, 2, 3, prefetch=2, **kw), want)


def test_registry_names_the_missing_datasets():
    """Every dataset of the JAX package's registry is in the port's, none
    missing, each the port's own class of the same name (KITTI and
    nuScenes: tests/test_torch_kitti.py, test_torch_nuscenes.py; Waymo,
    ONCE and the rest: test_torch_waymo.py, test_torch_once.py,
    test_torch_misc_datasets.py)."""
    assert set(TD.DATASET_REGISTRY) == set(JD.DATASET_REGISTRY)
    for name, cls in TD.DATASET_REGISTRY.items():
        assert cls.__name__ == name
        assert cls.__module__.startswith("findnpropagate_torch.datasets.")


def test_synthetic_evaluation_matches_jax():
    t = TSyn(EDict(data_cfg()), CLASSES)
    j = JSyn(JEDict(data_cfg()), CLASSES)
    rng = np.random.RandomState(0)
    dets = []
    for i in range(len(t)):
        g = t.generate_scene(i)["gt_boxes"]
        boxes = g + rng.uniform(-0.5, 0.5, g.shape).astype(np.float32)
        dets.append({"boxes": boxes, "scores": rng.rand(len(g)),
                     "labels": rng.randint(1, len(CLASSES) + 1, len(g))})
    got = t.evaluation(dets, CLASSES)
    assert_same(got, j.evaluation(dets, CLASSES))
    assert got[1]["mAP"] > 0


def test_synthetic_dataset_defaults_to_training_as_the_reference():
    import inspect

    for cls in (TSyn, JSyn):
        assert inspect.signature(cls).parameters["training"].default is True
    t, j = TSyn(EDict(data_cfg(augs=False)), CLASSES), JSyn(
        JEDict(data_cfg(augs=False)), CLASSES)
    assert t.training and j.training and t.base_seed == j.base_seed
    assert_same(t.generate_scene(1), j.generate_scene(1))


def test_prefetch_loader_passes_worker_error_and_stops():
    class Failing:
        def __init__(self, bad):
            self.bad, self.made = bad, []

        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == self.bad:
                raise KeyError(f"sample {i}")
            self.made.append(i)
            return {"i": i}

        def collate_batch(self, samples):
            return [s["i"] for s in samples]

    ds = Failing(3)
    loader = TD.PrefetchLoader(TD.DataLoader(ds, 1, shuffle=False),
                               prefetch=1)
    seen = []
    with pytest.raises(KeyError, match="sample 3"):
        for b in loader:
            seen.extend(b)
    assert seen == [0, 1, 2]
    # stopping early joins the worker: no sample is made afterwards
    ds = Failing(-1)
    it = iter(TD.PrefetchLoader(TD.DataLoader(ds, 1, shuffle=False),
                                prefetch=1))
    assert next(it) == [0]
    it.close()
    made = list(ds.made)
    assert len(made) <= 3 and ds.made == made


# ------------------------------------------------------------ gt sampling

def write_gt_database(root, n_scenes=3, classes=CLASSES, seed=0):
    """Per-object .bin files (5 columns: x, y, z relative to the box
    centre, intensity, a zero time lag) of synthetic scenes, and their
    dbinfos pickle; returns the infos."""
    cfg = data_cfg(augs=False, camera=False, scenes=n_scenes)
    cfg["SYNTHETIC"]["SEED"] = 100 + seed
    ds = TSyn(EDict(cfg), classes, training=True)
    infos = {n: [] for n in classes}
    (root / "gt_database").mkdir(parents=True, exist_ok=True)
    for s in range(n_scenes):
        d = ds.generate_scene(s)
        inside = TG.points_in_boxes_mask(d["points"][:, :3], d["gt_boxes"])
        for k, (box, name) in enumerate(zip(d["gt_boxes"], d["gt_names"])):
            pts = d["points"][inside[k]]
            rows = np.zeros((len(pts), 5), np.float32)
            rows[:, :4] = pts
            rows[:, :3] -= box[:3]
            rel = f"gt_database/{s}_{name}_{k}.bin"
            rows.tofile(root / rel)
            infos[str(name)].append({
                "name": str(name), "path": rel, "box3d_lidar": box.copy(),
                "num_points_in_gt": len(pts)})
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    return infos


def sampling_cfg(shared):
    aug = {"NAME": "gt_sampling", "DB_INFO_PATH": ["dbinfos.pkl"],
           "PREPARE": {"filter_by_min_points": ["Car:5", "Pedestrian:5",
                                                "Cyclist:5"]},
           "SAMPLE_GROUPS": ["Car:9", "Pedestrian:8", "Cyclist:8"],
           "NUM_POINT_FEATURES": 5}
    if shared:
        aug.update(USE_SHARED_MEMORY=True, DB_DATA_PATH=["gt_database.npy"])
    return {"AUG_CONFIG_LIST": [aug]}


def test_build_shared_database_matches_jax(tmp_path):
    infos = write_gt_database(tmp_path)
    got = tdb.build_shared_database(pickle.loads(pickle.dumps(infos)),
                                    tmp_path, tmp_path / "t.npy")
    want = jdb.build_shared_database(pickle.loads(pickle.dumps(infos)),
                                     tmp_path, tmp_path / "j.npy")
    assert_same(got, want)
    assert_same(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))


@pytest.mark.parametrize("shared", [False, True])
def test_gt_sampling_matches_jax(tmp_path, shared):
    """gt_sampling from a database written by build_shared_database
    (memmap) or read per file, on three scenes in a row."""
    infos = write_gt_database(tmp_path)
    infos = tdb.build_shared_database(infos, tmp_path,
                                      tmp_path / "gt_database.npy")
    with open(tmp_path / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    conf = sampling_cfg(shared)
    scenes = [make_scene(s) for s in range(3)]
    np.random.seed(4)
    jaug = JAug(conf, CLASSES, root_path=str(tmp_path))
    want = [jaug.forward(copy_scene(d)) for d in scenes]
    taug = TAug(conf, CLASSES, root_path=str(tmp_path),
                rng=np.random.RandomState(4))
    assert taug.queue[0].enabled
    assert (taug.queue[0].db_data is not None) == shared
    got = [taug.forward(copy_scene(d)) for d in scenes]
    assert_same(got, want)
    assert sum(len(g["gt_boxes"]) for g in got) > 9


def test_road_plane_matches_jax(tmp_path):
    """USE_ROAD_PLANE (ported with KITTI's calibration, ROADMAP item 14):
    the pasted boxes and their points are set on the scene's road plane,
    as the reference sets them; a scene without a plane or calib is left
    as plain gt_sampling leaves it."""
    infos = write_gt_database(tmp_path)
    with open(tmp_path / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    conf = sampling_cfg(False)
    conf["AUG_CONFIG_LIST"][0]["USE_ROAD_PLANE"] = True
    calib = {"P2": np.array([[700, 0, 600, 45], [0, 700, 180, 0.2],
                             [0, 0, 1, 0.003]], np.float32),
             "R0": np.eye(3, dtype=np.float32),
             "V2C": np.array([[0, -1, 0, 0], [0, 0, -1, -0.08],
                              [1, 0, 0, -0.27]], np.float32)}
    scenes = []
    for s in range(3):
        d = make_scene(s)
        if s < 2:
            d["calib"] = calib
            d["road_plane"] = np.array([0.01 * s, -1.0, 0.02, 1.7],
                                       np.float32)
        scenes.append(d)
    np.random.seed(4)
    jaug = JAug(conf, CLASSES, root_path=str(tmp_path))
    want = [jaug.forward(copy_scene(d)) for d in scenes]
    taug = TAug(conf, CLASSES, root_path=str(tmp_path),
                rng=np.random.RandomState(4))
    got = [taug.forward(copy_scene(d)) for d in scenes]
    assert_same(got, want)
    plain = TAug(sampling_cfg(False), CLASSES, root_path=str(tmp_path),
                 rng=np.random.RandomState(4))
    flat = [plain.forward(copy_scene(d)) for d in scenes]
    assert not np.array_equal(got[0]["gt_boxes"], flat[0]["gt_boxes"])
    assert_same(got[2]["gt_boxes"], flat[2]["gt_boxes"])
