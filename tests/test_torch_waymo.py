"""The port's Waymo data layer (datasets/waymo_proto.py, waymo_infos.py,
waymo.py, waymo_eval.py, the create_infos CLI's waymo mode) against the JAX
package's, and the port's train.py / test.py on a small Waymo tree against
the JAX CLI's eval_ckpt.

Raw trees come from chip_smoke.write_waymo_tree at a small size (the
writer of the smoke run's phase 14: lidar_ring scenes rendered into a TOP
lidar of two returns with a pixel pose and four side lidars), written by
the port's encoders. Tolerances: the TFRecord / protobuf layer, the info
generation (the .npy bytes and the .pkl content), the gt database and the
loader's items at the same seed (the reference draws from numpy's global
state after ``np.random.seed(s)``, the port from the dataset's
``RandomState(s)``) are bit for bit; the evaluations' numbers, whose IoUs
come from the two packages' rotated-IoU ops (torch and JAX, float32),
within 1e-5 absolute; the CLI's detections as tests/test_torch_cli.py
holds them (boxes and scores 1e-4, labels exact) and its result 1e-4."""

import copy
import dataclasses
import importlib.util
import json
import logging
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import findnpropagate_torch.datasets.waymo_eval as TWE
import findnpropagate_torch.datasets.waymo_infos as TWI
import findnpropagate_torch.datasets.waymo_proto as TWP
import findnpropagate_tpu.datasets.waymo_eval as JWE
import findnpropagate_tpu.datasets.waymo_infos as JWI
import findnpropagate_tpu.datasets.waymo_proto as JWP
import test_official_evals as REF_CASES
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets import build_dataloader as torch_loader
from findnpropagate_torch.datasets.waymo import WaymoDataset as TWay
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.runtime.trainer import (
    latest_checkpoint,
    restore_checkpoint,
)
from findnpropagate_torch.tools import create_infos
from findnpropagate_torch.tools import test as test_cli
from findnpropagate_torch.tools import train as train_cli
from findnpropagate_torch.utils.weights import to_jax_tree
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.config import cfg_from_yaml_file as jax_cfg
from findnpropagate_tpu.datasets import build_dataloader as jax_loader
from findnpropagate_tpu.datasets.waymo import WaymoDataset as JWay
from findnpropagate_tpu.models import build_network as jax_build
from test_torch_cli import rounded_post_process
from test_torch_datasets import assert_same

CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
EVAL_ATOL = 1e-5
SMALL = dict(top=(16, 512), side=(8, 128), raw_points=20000, n_objects=8,
             pcr=(-20.0, -20.0, -2.0, 20.0, 20.0, 4.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_small_tree(root, splits=None):
    chip_smoke.write_waymo_tree(
        root, splits or {"train": (2, 4), "val": (1, 2)}, **SMALL)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A small raw tree with its infos and gt database, made by the JAX
    package (the port's are held against them below)."""
    root = write_small_tree(tmp_path_factory.mktemp("waymo") / "raw")
    JWI.create_waymo_infos(root)
    JWI.create_waymo_gt_database(root)
    return root


# ------------------------------------------------------- TFRecord / proto


@pytest.mark.parametrize("n", [0, 1, 200, 262143, 262144, 300007])
def test_crc32c_matches_jax(n):
    """The port's vectorised CRC32C (lanes chained through the zero-byte
    map) against the JAX package's byte loop, at lengths on both sides of
    the vectorised path's threshold."""
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    assert TWP._crc32c(data) == JWP._crc32c(data)
    assert TWP._masked_crc(data) == JWP._masked_crc(data)


def test_tfrecord_framing_both_ways(tmp_path):
    payloads = [b"", b"abc", bytes(range(256)) * 7,
                np.random.RandomState(0).bytes(700_001)]
    TWP.write_tfrecord(tmp_path / "t.tfrecord", payloads)
    JWP.write_tfrecord(tmp_path / "j.tfrecord", payloads)
    assert (tmp_path / "t.tfrecord").read_bytes() == \
        (tmp_path / "j.tfrecord").read_bytes()
    assert list(JWP.read_tfrecord(tmp_path / "t.tfrecord",
                                  check_crc=True)) == payloads
    assert list(TWP.read_tfrecord(tmp_path / "j.tfrecord",
                                  check_crc=True)) == payloads
    bad = bytearray((tmp_path / "t.tfrecord").read_bytes())
    bad[100] ^= 1                  # inside the third payload
    (tmp_path / "bad.tfrecord").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        list(TWP.read_tfrecord(tmp_path / "bad.tfrecord", check_crc=True))
    assert len(list(TWP.read_tfrecord(tmp_path / "bad.tfrecord"))) == 4


def test_golden_fixture_decodes_to_its_expected_values():
    """tests/fixtures/waymo_golden.tfrecord was assembled from the public
    schema with no code of either package: it pins the field numbers."""
    fdir = Path(__file__).resolve().parent / "fixtures"
    recs = list(TWP.read_tfrecord(fdir / "waymo_golden.tfrecord",
                                  check_crc=True))
    assert len(recs) == 1
    exp = json.loads((fdir / "waymo_golden_expected.json").read_text())
    fr = TWP.Frame.parse(recs[0])
    assert fr.context_name == exp["context_name"]
    assert fr.timestamp_micros == exp["timestamp_micros"]
    np.testing.assert_array_equal(fr.pose[:3, 3], exp["pose_translation"])
    cal = fr.laser_calibrations[0]
    assert cal.name == 1
    np.testing.assert_array_equal(cal.beam_inclinations,
                                  exp["beam_inclinations"])
    assert cal.extrinsic[2, 3] == exp["extrinsic_z"]
    ri = fr.lasers[0].ri_return1.range_image
    assert list(ri.shape) == exp["range_image_shape"]
    np.testing.assert_allclose(ri[:, :, 0], exp["ranges"], rtol=1e-7)
    assert len(fr.laser_labels) == 2
    for lab, e in zip(fr.laser_labels, exp["labels"]):
        np.testing.assert_array_equal(lab.center, e["center"])
        assert [lab.length, lab.width, lab.height] == e["lwh"]
        assert lab.heading == e["heading"]
        assert lab.type == e["type"] and lab.id == e["id"]
        assert lab.detection_difficulty_level == e["difficulty"]
        assert lab.num_lidar_points_in_box == e["num_points"]
        np.testing.assert_array_equal(lab.speed, e["speed"])
    assert_same(dataclasses.asdict(fr), dataclasses.asdict(
        JWP.Frame.parse(recs[0])))


def encoded_frame(wp, rng):
    """One Frame through `wp`'s encoders: a TOP lidar with two returns and
    a pixel pose, a FRONT lidar in the min / max inclination form, two
    labels, from the numbers `rng` draws."""
    extr = np.eye(4)
    extr[:3, :3] = chip_smoke.rot_z(rng.uniform(-1, 1))
    extr[:3, 3] = rng.uniform(-2, 2, 3)
    pose = chip_smoke.pose_matrix(rng.uniform(-3, 3), *rng.uniform(-50, 50,
                                                                   2))
    ri = rng.uniform(0, 30, (4, 32, 4)).astype(np.float32)
    pp = rng.uniform(-1, 1, (4, 32, 6)).astype(np.float32)
    lasers = [wp.encode_laser(wp.LASER_TOP, wp.encode_range_image(ri, pp),
                              wp.encode_range_image(ri[::-1])),
              wp.encode_laser(wp.LASER_FRONT, wp.encode_range_image(ri))]
    calibs = [wp.encode_laser_calibration(wp.LASER_TOP, extr,
                                          rng.uniform(-0.3, 0.1, 4)),
              wp.encode_laser_calibration(wp.LASER_FRONT, extr,
                                          incl_min=-0.5, incl_max=0.2)]
    labels = [wp.encode_label(rng.uniform(-9, 9, 3), rng.uniform(1, 4, 3),
                              rng.uniform(-3, 3), t, f"obj-{t}",
                              difficulty=t % 3, tracking_difficulty=1,
                              num_points=int(rng.randint(0, 99)),
                              speed=tuple(rng.uniform(-2, 2, 2)),
                              accel=tuple(rng.uniform(-1, 1, 2)))
              for t in (1, 4)]
    return wp.encode_frame("ctx", int(rng.randint(1, 2 ** 40)), pose,
                           calibs, lasers, labels)


def test_encoders_and_decoders_match_jax_both_ways():
    """The same numbers through both packages' encoders give the same
    bytes, and both decoders read them into equal frames."""
    mine = encoded_frame(TWP, np.random.RandomState(5))
    theirs = encoded_frame(JWP, np.random.RandomState(5))
    assert mine == theirs
    assert_same(dataclasses.asdict(TWP.Frame.parse(theirs)),
                dataclasses.asdict(JWP.Frame.parse(mine)))
    arr = np.random.RandomState(1).randn(3, 5, 4).astype(np.float32)
    assert TWP.encode_matrix_float(arr) == JWP.encode_matrix_float(arr)
    np.testing.assert_array_equal(
        TWP.decode_matrix_float(JWP.encode_matrix_float(arr)), arr)


# ---------------------------------------------------------- range images


@pytest.mark.parametrize("pixel_pose", [False, True])
def test_range_image_to_cartesian_matches_jax(pixel_pose):
    rng = np.random.RandomState(2)
    ri = rng.uniform(0, 40, (8, 64)).astype(np.float32)
    ri[rng.rand(8, 64) < 0.3] = 0
    extr = np.eye(4)
    extr[:3, :3] = JWI._rotation_zyx(0.01, -0.02, 0.7)
    extr[:3, 3] = [1.2, -0.3, 2.0]
    incl = np.linspace(-0.4, 0.1, 8)[::-1]
    kw = {}
    if pixel_pose:
        kw["pixel_pose"] = rng.uniform(-0.1, 0.1, (8, 64, 6))
        kw["pixel_pose"][..., 3:] += [100.0, -50.0, 1.0]
        kw["frame_pose"] = chip_smoke.pose_matrix(0.4, 100.0, -50.0)
    got = TWI.range_image_to_cartesian(ri, extr, incl, **kw)
    want = JWI.range_image_to_cartesian(ri, extr, incl, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TWI.compute_inclination(-0.5, 0.2, 9),
                                  JWI.compute_inclination(-0.5, 0.2, 9))


@pytest.mark.parametrize("ri_index", [(0, 1), (0,)])
def test_convert_frame_to_points_and_labels_match_jax(tmp_path, ri_index):
    root = write_small_tree(tmp_path, {"train": (1, 1)})
    rec = next(TWP.read_tfrecord(next((root / "raw_data").iterdir())))
    got = TWI.convert_frame_to_points(TWP.Frame.parse(rec), ri_index)
    want = JWI.convert_frame_to_points(JWP.Frame.parse(rec), ri_index)
    assert_same(got, want)
    assert len(got) == 5 and all(len(p) for p in got)
    frame = TWP.Frame.parse(rec)
    assert_same(TWI.generate_labels(frame, frame.pose.astype(np.float32)),
                JWI.generate_labels(JWP.Frame.parse(rec),
                                    frame.pose.astype(np.float32)))


def test_render_draws_every_pixel_back_to_its_point():
    """chip_smoke.render_range_image: a point drawn into a pixel comes back
    out of range_image_to_cartesian on that pixel's ray at its range."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-30, 30, (3000, 3))
    pts[:, 2] = rng.uniform(-1, 3, 3000)
    extra = rng.uniform(0, 1, (3000, 3))
    extr = chip_smoke.waymo_extrinsic(1)
    incl = np.deg2rad(np.linspace(-17.6, 2.4, 16))[::-1]
    (ri,), drawn = chip_smoke.render_range_image(pts, extra, extr, incl,
                                                 256, 75.2)
    assert 0 < len(drawn) == int((ri[..., 0] > 0).sum())
    xyz = TWI.range_image_to_cartesian(ri[..., 0], extr, incl)
    back = xyz[ri[..., 0] > 0]
    r_back = np.linalg.norm(back - extr[:3, 3], axis=1)
    r_pts = np.sort(np.linalg.norm(pts[drawn] - extr[:3, 3], axis=1))
    np.testing.assert_allclose(np.sort(r_back), r_pts, rtol=1e-5)


# --------------------------------------------------------- info generation


def test_process_single_sequence_matches_jax(tree, tmp_path):
    """Every sequence: the same %04d.npy bytes and the same <seq>.pkl."""
    out = TWI.create_waymo_infos(tree, tmp_path)
    assert sum(len(v) for v in out.values()) == 10
    mine = tmp_path / "waymo_processed_data"
    theirs = tree / "waymo_processed_data"
    seqs = sorted(p.name for p in theirs.iterdir())
    assert seqs == sorted(p.name for p in mine.iterdir()) and len(seqs) == 3
    for seq in seqs:
        files = sorted(p.name for p in (theirs / seq).iterdir())
        assert files == sorted(p.name for p in (mine / seq).iterdir())
        for f in files:
            if f.endswith(".npy"):
                assert (mine / seq / f).read_bytes() == \
                    (theirs / seq / f).read_bytes(), f
        assert_same(pickle.loads((mine / seq / f"{seq}.pkl").read_bytes()),
                    pickle.loads((theirs / seq / f"{seq}.pkl").read_bytes()))
    # a second run reads the existing pkl
    again = TWI.process_single_sequence(
        tree / "raw_data" / f"{seqs[0]}.tfrecord", mine)
    assert len(again) in (2, 4)


def test_sampled_interval_and_single_return_match_jax(tree, tmp_path):
    got = TWI.create_waymo_infos(tree, tmp_path / "t", sampled_interval=3,
                                 use_two_returns=False)
    want = JWI.create_waymo_infos(tree, tmp_path / "j", sampled_interval=3,
                                  use_two_returns=False)
    assert_same(got, want)
    assert [i["point_cloud"]["sample_idx"] for i in got["train"]] == [
        0, 3, 0, 3]


def test_gt_database_matches_jax(tree, tmp_path):
    TWI.create_waymo_infos(tree, tmp_path)
    JWI.create_waymo_infos(tree, tmp_path / "j")
    fp = TWI.create_waymo_gt_database(tree, tmp_path,
                                      used_classes=["Vehicle", "Cyclist"])
    want = JWI.create_waymo_gt_database(tree, tmp_path / "j",
                                        used_classes=["Vehicle", "Cyclist"])
    got = pickle.loads(fp.read_bytes())
    assert_same(got, pickle.loads(want.read_bytes()))
    assert set(got) <= {"Vehicle", "Cyclist"} and got
    for infos in got.values():
        for info in infos:
            assert (tmp_path / info["path"]).read_bytes() == \
                (tmp_path / "j" / info["path"]).read_bytes()


def test_gt_database_keeps_raw_intensity(tree):
    """The crops keep the .npy's raw intensity while the loader applies
    tanh to its own points (the reference's trait)."""
    db = pickle.loads((tree / "waymo_dbinfos_train.pkl").read_bytes())
    info = next(i for v in db.values() for i in v
                if i["num_points_in_gt"] > 0)
    crop = np.fromfile(tree / info["path"], np.float32).reshape(-1, 5)
    seq, idx = info["image_idx"].rsplit("_", 1)
    raw = np.load(tree / "waymo_processed_data" / seq / f"{idx}.npy")
    assert np.isin(crop[:, 3], raw[:, 3]).all()
    assert crop[:, 3].max() > 1.0          # beyond tanh's range


def test_create_infos_cli_waymo(tree, tmp_path):
    rc = create_infos.main(["waymo", "--data_path", str(tree),
                            "--save_path", str(tmp_path), "--gt_database",
                            "--classes", "Vehicle", "Pedestrian"])
    assert rc == 0
    JWI.create_waymo_infos(tree, tmp_path / "j")
    want = JWI.create_waymo_gt_database(
        tree, tmp_path / "j", used_classes=["Vehicle", "Pedestrian"])
    assert_same(pickle.loads((tmp_path / "waymo_dbinfos_train.pkl")
                             .read_bytes()),
                pickle.loads(want.read_bytes()))


# ----------------------------------------------------------------- loader


def waymo_cfg(root, **kw):
    with open("tools/cfgs/dataset_configs/waymo_dataset.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(DATA_PATH=str(root), PROCESSED_DATA_TAG="waymo_processed_data",
               POINT_CLOUD_RANGE=[-25.6, -25.6, -2.0, 25.6, 25.6, 4.0],
               SAMPLED_INTERVAL={"train": 2, "test": 1},
               CAPACITIES=dict(cfg["CAPACITIES"], MAX_POINTS=40000,
                               MAX_VOXELS=8000))
    sampling = cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0]
    sampling["SAMPLE_GROUPS"] = ["Vehicle:3", "Pedestrian:2", "Cyclist:2"]
    sampling["PREPARE"]["filter_by_min_points"] = [
        "Vehicle:1", "Pedestrian:1", "Cyclist:1"]
    for p in cfg["DATA_PROCESSOR"]:
        if p["NAME"] == "transform_points_to_voxels":
            p["VOXEL_SIZE"] = [0.2, 0.2, 0.15]
    cfg.update(kw)
    return cfg


def both_items(cfg, training, seed=7, indices=None):
    np.random.seed(seed)
    jds = JWay(JEDict(copy.deepcopy(cfg)), CLASSES, training=training)
    want = [jds[i] for i in (indices or range(len(jds)))]
    tds = TWay(EDict(copy.deepcopy(cfg)), CLASSES, training=training,
               rng=np.random.RandomState(seed))
    assert_same(tds.infos, jds.infos)
    got = [tds[i] for i in (indices or range(len(tds)))]
    assert_same(got, want)
    return tds, got


@pytest.mark.parametrize("training,nlz", [(True, True), (True, False),
                                          (False, True)])
def test_dataset_items_match_jax(tree, training, nlz):
    """Single-frame items: SAMPLED_INTERVAL, the NLZ filter (with
    DISABLE_NLZ_FLAG_ON_POINTS off), tanh of the intensity, the unknown /
    empty-box filters, gt_sampling from the tree's database and the
    augmentations."""
    cfg = waymo_cfg(tree, DISABLE_NLZ_FLAG_ON_POINTS=nlz)
    ds, items = both_items(cfg, training)
    assert len(ds) == (4 if training else 2)
    assert items[0]["points"].shape[1] == 5
    raw = ds.get_lidar(*[ds.infos[0]["point_cloud"][k] for k in (
        "lidar_sequence", "sample_idx")])
    assert np.abs(raw[:, 3]).max() < 1.0
    if training:
        assert all(len(i["gt_boxes"]) > 0 for i in items)


def test_build_dataloader_builds_waymo(tree):
    ds, loader, _ = torch_loader(EDict(waymo_cfg(tree)), CLASSES,
                                 batch_size=2, seed=3, prefetch=0)
    assert isinstance(ds, TWay)
    batch = next(iter(loader))
    assert batch["points"].shape == (2, 40000, 5)


def pred_boxes_file(root, ds, path, with_names):
    """A first stage's result.pkl over every frame of the tree's
    sequences: boxes of 9 (with velocity), scores, names or labels."""
    rng = np.random.RandomState(1)
    dets = []
    for seq, infos in ds.seq_name_to_infos.items():
        for info in infos:
            n = rng.randint(0, 5)
            b = np.zeros((n, 9), np.float32)
            b[:, :3] = rng.uniform(-15, 15, (n, 3))
            b[:, 3:6] = rng.uniform(1, 4, (n, 3))
            b[:, 6:] = rng.uniform(-2, 2, (n, 3))
            d = {"frame_id": f"training_{seq}_%03d"
                 % info["point_cloud"]["sample_idx"],
                 "boxes_lidar": b, "score": rng.rand(n)}
            if with_names:
                d["name"] = np.array([CLASSES[i] for i in rng.randint(
                    0, 3, n)])
            else:
                d["pred_labels"] = rng.randint(1, 4, n)
            dets.append(d)
    with open(path, "wb") as f:
        pickle.dump(dets, f)


@pytest.mark.parametrize("with_names", [True, False])
def test_sequence_items_with_pred_boxes_match_jax(tree, tmp_path,
                                                  with_names):
    """SEQUENCE_CONFIG (two earlier frames stacked into the current one in
    float64 poses, a time channel) with USE_PREDBOX (the first stage's
    boxes of each frame moved into the current one); the multi-frame
    database the yaml names is absent, and the sampler skips it."""
    cfg = waymo_cfg(
        tree, SEQUENCE_CONFIG={"ENABLED": True, "SAMPLE_OFFSET": [-2, 0]},
        USE_PREDBOX=True, MAX_ROIS=6,
        ROI_BOXES_PATH={"train": str(tmp_path / "pred.pkl"),
                        "test": str(tmp_path / "pred.pkl")},
        SAMPLED_INTERVAL={"train": 1, "test": 1})
    cfg["POINT_FEATURE_ENCODING"] = {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity", "elongation",
                              "timestamp"],
        "src_feature_list": ["x", "y", "z", "intensity", "elongation",
                             "timestamp"]}
    sampling = cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0]
    sampling.update(DB_INFO_PATH=["waymo_dbinfos_train_multiframe.pkl"],
                    NUM_POINT_FEATURES=6)
    seq_cfg = dict(cfg, SEQUENCE_CONFIG={"ENABLED": False},
                   USE_PREDBOX=False)
    pred_boxes_file(tree, TWay(EDict(seq_cfg), CLASSES), tmp_path /
                    "pred.pkl", with_names)
    ds, items = both_items(cfg, True, indices=[0, 1, 3])
    assert not ds.data_augmentor.queue[0].enabled      # no database
    assert items[0]["points"].shape[1] == 6
    assert set(np.unique(items[2]["points"][:, 5])) <= {
        np.float32(0.0), np.float32(0.1), np.float32(0.2)}
    assert items[0]["roi_boxes"].shape == (3, 6, 9)
    pose_pre = np.asarray(ds.infos[0]["pose"], np.float64)
    pose_cur = np.asarray(ds.infos[3]["pose"], np.float64)
    boxes = np.random.RandomState(3).uniform(-5, 5, (4, 11)).astype(
        np.float32)
    assert_same(TWay.transform_prebox_to_current(boxes, pose_pre, pose_cur),
                JWay.transform_prebox_to_current(boxes, pose_pre, pose_cur))


# ------------------------------------------------------------- evaluation


def close(got, want, path="out"):
    """Equal structure; floats within EVAL_ATOL, the rest equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            close(a, b, f"{path}[{i}]")
    elif isinstance(want, str):
        assert isinstance(got, str), path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=0,
                                   atol=EVAL_ATOL, err_msg=path)


def random_frames(seed, n_frames=4, names=True):
    """Ground truths of every Waymo class with mixed difficulty and point
    counts (some empty), and detections: jittered ground truths, some
    flipped in heading, plus false positives."""
    rng = np.random.RandomState(seed)
    all_names = ["Vehicle", "Pedestrian", "Sign", "Cyclist"]
    gts, dets = [], []
    for _ in range(n_frames):
        n = rng.randint(0, 9)
        b = np.zeros((n, 9))
        b[:, :2] = rng.uniform(-40, 40, (n, 2))
        b[:, 2] = rng.uniform(0, 2, n)
        b[:, 3:6] = rng.uniform(0.6, 5, (n, 3))
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
        gt_names = np.array([all_names[i] for i in rng.randint(0, 4, n)])
        gts.append({"name": gt_names, "gt_boxes_lidar": b,
                    "difficulty": rng.randint(0, 3, n),
                    "num_points_in_gt": rng.randint(0, 12, n)})
        keep = rng.rand(n) < 0.8
        d = b[keep, :7].copy()
        d[:, :3] += rng.normal(0, 0.15, (len(d), 3))
        d[:, 6] += np.where(rng.rand(len(d)) < 0.2, np.pi, 0.0)
        fp = np.zeros((3, 7))
        fp[:, :2] = rng.uniform(-40, 40, (3, 2))
        fp[:, 3:6] = [4.0, 2.0, 1.5]
        d = np.concatenate([d, fp])
        det = {"boxes_lidar": d, "score": rng.rand(len(d))}
        if names:
            det["name"] = np.concatenate([gt_names[keep], np.array(
                [all_names[i] for i in rng.randint(0, 4, 3)])])
        dets.append(det)
    return gts, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_waymo_eval_matches_jax(seed):
    gts, dets = random_frames(seed)
    classes = ["Vehicle", "Pedestrian", "Sign", "Cyclist"]
    want = JWE.waymo_eval(gts, dets, classes)
    got = TWE.waymo_eval(copy.deepcopy(gts), copy.deepcopy(dets), classes)
    close(got, want)
    assert any(v > 0 for v in got[1].values())
    for level in (1, 2):
        for cls in classes:
            want = JWE.eval_class_level(gts, dets, cls, level)
            close(TWE.eval_class_level(gts, dets, cls, level), want)


def test_evaluation_without_names_counts_every_class(tree):
    """eval_ckpt's det_annos carry boxes / scores / labels and no names:
    waymo_eval then counts every detection in every class (the reference's
    trait), in both packages. A frame's ground truths as detections, all
    labelled Pedestrian, still score on every class present."""
    cfg = waymo_cfg(tree)
    tds = TWay(EDict(copy.deepcopy(cfg)), CLASSES, training=False)
    jds = JWay(JEDict(copy.deepcopy(cfg)), CLASSES, training=False)
    dets = [{"boxes": np.asarray(i["annos"]["gt_boxes_lidar"])[:, :7],
             "scores": np.linspace(0.9, 0.1, len(i["annos"]["name"])),
             "labels": np.full(len(i["annos"]["name"]), 2)}
            for i in tds.infos]
    got = tds.evaluation(copy.deepcopy(dets), CLASSES, known_classes=None)
    want = jds.evaluation(copy.deepcopy(dets), CLASSES)
    close(got, want)
    present = {n for i in tds.infos for n in i["annos"]["name"]} & set(
        CLASSES)
    for cls in present:
        assert got[1][f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_2/AP"] > 0, cls
    simple = tds.evaluation(copy.deepcopy(dets), CLASSES,
                            eval_metric="simple")
    close(simple, jds.evaluation(copy.deepcopy(dets), CLASSES,
                                 eval_metric="simple"))


def twin(module_ref, module_port, name, calls):
    """module_ref.name that also runs the port's function on a copy of the
    same arguments and holds the two results within EVAL_ATOL."""
    ref, mine = getattr(module_ref, name), getattr(module_port, name)

    def run(*a, **kw):
        got = mine(*copy.deepcopy(a), **copy.deepcopy(kw))
        want = ref(*a, **kw)
        close(got, want, name)
        calls.append(name)
        return want
    return run


@pytest.mark.parametrize("case", sorted(
    n for n in dir(REF_CASES) if n.startswith("test_waymo")
    or n == "test_heading_sim_wraps"))
def test_reference_waymo_eval_cases_match_jax(case, monkeypatch):
    """The Waymo cases of tests/test_official_evals.py, with each call of
    the evaluator there also made to the port's and held equal."""
    calls = []
    for name in ("waymo_eval", "_ap_from_matches", "_heading_sim"):
        monkeypatch.setattr(REF_CASES, name, twin(JWE, TWE, name, calls))
    getattr(REF_CASES, case)()
    assert calls


# ------------------------------------------------------------------- CLIs


WAYMO_YAML = "tools/cfgs/waymo_models/centerpoint.yaml"


def narrow_yaml(root, path):
    """The Waymo CenterPoint yaml narrowed (16 channels, +-25.6 m on a 256
    x 256 x 40 grid, SUBM_IMPL pallas), with the small tree's DATA_CONFIG:
    4 train frames (SAMPLED_INTERVAL 2 of 8) in two steps of 2, no
    shuffling."""
    with open(WAYMO_YAML) as f:
        cfg = yaml.safe_load(f)
    data = waymo_cfg(root)
    for p in data["DATA_PROCESSOR"]:
        if p["NAME"] == "shuffle_points":
            p["SHUFFLE_ENABLED"] = {"train": False, "test": False}
    data["CAPACITIES"].update(MAX_POINTS=16000, MAX_VOXELS=4096)
    cfg["DATA_CONFIG"] = data
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
    cfg["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"] = 2
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A small tree (8 train frames, 2 val), its infos and gt database
    through the port's create_infos, the narrow yaml, and the checkpoint of
    `train.py --epochs 1 --device cpu`, run in a scratch directory."""
    work = tmp_path_factory.mktemp("waymo_cli")
    root = write_small_tree(work / "raw", {"train": (1, 8), "val": (1, 2)})
    assert create_infos.main(["waymo", "--data_path", str(root),
                              "--gt_database"]) == 0
    cfg_path = narrow_yaml(root, work / "cp_waymo.yaml")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc = train_cli.main(["--cfg_file", str(cfg_path), "--epochs", "1",
                             "--seed", "3", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    run = work / "output" / work.name / "cp_waymo" / "default"
    return work, cfg_path, run


def test_train_cli_trains_two_steps_on_waymo(trained):
    work, cfg_path, run = trained
    ckpt = latest_checkpoint(run / "ckpt")
    assert ckpt is not None
    state = torch.load(ckpt, weights_only=True)
    assert state["optimizer"]["count"] == 2
    log = next(run.glob("log_train_*.txt")).read_text()
    assert "epoch 0 it 0/2" in log and "training done" in log


@pytest.fixture(scope="module")
def evaluated(trained):
    work, cfg_path, run = trained
    logger = logging.getLogger("test_torch_waymo")
    cfg = test_cli.parse_config(["--cfg_file", str(cfg_path)])[1]
    names = list(cfg.CLASS_NAMES)
    ds, loader, _ = torch_loader(cfg.DATA_CONFIG, names, batch_size=2,
                                 training=False)
    det = torch_build(copy.deepcopy(cfg.MODEL), num_class=3, dataset=ds,
                      device="cpu")
    restore_checkpoint(latest_checkpoint(run / "ckpt"), det)
    det.post_process = rounded_post_process(det.post_process, torch.round)
    t_annos, t_res = test_cli.eval_ckpt(det, loader, ds, logger, names)

    spec = importlib.util.spec_from_file_location("jax_test_cli",
                                                  "tools/test.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcfg = jax_cfg(str(cfg_path))
    jcfg.MODEL.BACKBONE_3D.SUBM_IMPL = "xla"
    jcfg.MODEL.BACKBONE_3D.WINDOWED_PRECISION = "highest"
    jds, jloader, _ = jax_loader(jcfg.DATA_CONFIG, names, batch_size=2,
                                 training=False, prefetch=0)
    jdet = jax_build(jcfg.MODEL, num_class=3, dataset=jds)
    jdet.post_process = rounded_post_process(jdet.post_process, jnp.round)
    variables = {"params": to_jax_tree(det, "param"),
                 "batch_stats": to_jax_tree(det, "batch_stats")}
    with jax.default_matmul_precision("highest"):
        j_annos, j_res = jcli.eval_ckpt(jdet, jloader, jds, variables,
                                        logger, names)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc = test_cli.main(["--cfg_file", str(cfg_path), "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    return t_annos, t_res, j_annos, j_res, run


def test_eval_ckpt_detections_match_jax(evaluated):
    t_annos, _, j_annos, _, _ = evaluated
    assert len(t_annos) == len(j_annos) == 2
    for t, j in zip(t_annos, j_annos):
        assert t["frame_id"] == j["frame_id"]
        assert "name" not in t and "name" not in j
        np.testing.assert_array_equal(t["labels"], j["labels"])
        np.testing.assert_allclose(t["boxes"], j["boxes"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-4,
                                   atol=1e-4)
    assert sum(len(t["labels"]) for t in t_annos) > 0


def test_eval_ckpt_result_matches_jax_with_waymo_keys(evaluated):
    _, t_res, _, j_res, run = evaluated
    assert set(t_res) == set(j_res)
    for cls in CLASSES:
        for level in (1, 2):
            for m in ("AP", "APH"):
                key = f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_{level}/{m}"
                assert np.isfinite(t_res[key]), key
    for k, v in j_res.items():
        np.testing.assert_allclose(t_res[k], v, atol=1e-4, err_msg=k)
    got = json.loads((run / "eval" / "result.json").read_text())
    assert set(got) == set(t_res)


# ------------------------------------------------------- overflow counter


def test_transposed_overflow_counts_the_input_padding_as_the_reference():
    """A differentiable strided conv checks its transposed direction with
    the strided base ids' sentinel start, below which the input list's own
    padding lies: a block of real inputs followed by padding counts the
    padding's span. The port's counter equals the JAX package's, and
    chip_smoke.overflow_sites' recount with the input list's own sentinel
    start drops exactly that block (the 4-frame Waymo training batch meets
    it)."""
    from findnpropagate_torch.ops import sparse_ops as so
    from findnpropagate_torch.ops import windowed_sparse as ws
    from findnpropagate_tpu.ops.pallas_sparse import windowed_overflow

    s_in, s_out = (41, 200, 200), (21, 100, 100)
    rng = np.random.RandomState(0)
    c = np.unique(np.stack([rng.randint(0, n, 20000) for n in s_in], 1),
                  axis=0)[:3900]
    sx, sy = so.yxz_strides(s_in)
    ids = np.sort(c[:, 1] * sy + c[:, 2] * sx + c[:, 0])
    src = np.concatenate([ids, so.yxz_sentinel_start(s_in)
                          + np.arange(len(ids), 4096)]).astype(np.int32)
    oc = np.unique(c // 2, axis=0)[:1200]
    ov = torch.arange(2048)[None] < len(oc)
    tgt = so.strided_base_ids(torch.from_numpy(np.pad(
        oc, ((0, 2048 - len(oc)), (0, 0))))[None], ov, (2, 2, 2), s_in,
        s_out)[0].int().numpy()
    d = np.asarray(so.strided_deltas((3, 3, 3), (2, 2, 2), (1, 1, 1), s_in),
                   np.int64)
    sent = so.strided_sentinel_start(s_in)
    t = lambda a: torch.from_numpy(a)[None]  # noqa: E731
    got = int(ws.windowed_overflow(t(tgt), t(src), -d, 512, 512,
                                   sentinel_start=sent))
    want = int(windowed_overflow(jnp.asarray(tgt), jnp.asarray(src),
                                 jnp.asarray(-d), 512, 512,
                                 sentinel_start=sent))
    own = int(ws.windowed_overflow(t(tgt), t(src), -d, 512, 512,
                                   sentinel_start=so.yxz_sentinel_start(s_in)))
    assert got == want == own + 1
