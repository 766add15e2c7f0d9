"""The port's Remote Propagator data machinery (findnpropagate_torch/
openvocab/pseudo_labels.py and the hooks of self_training.py) against the
JAX package's, on the same inputs and seeds: the reference draws from
numpy's global state after ``np.random.seed(s)``, the port from the
``RandomState(s)`` it is handed. All numpy (and the same C++ IoU), so
every comparison is bit for bit."""

import pickle

import numpy as np
import pytest

import findnpropagate_tpu.datasets as JD
from findnpropagate_torch import datasets as TD
from findnpropagate_torch.config import EDict, cfg_from_yaml_file
from findnpropagate_torch.openvocab import pseudo_labels as TP
from findnpropagate_torch.openvocab.self_training import (
    register_pseudo_hooks as t_register,
)
from findnpropagate_torch.utils import geometry_np as TG
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets.augmentor import data_augmentor as jaug
from findnpropagate_tpu.openvocab import pseudo_labels as JP
from findnpropagate_tpu.openvocab.self_training import (
    register_pseudo_hooks as j_register,
)
from test_torch_datasets import assert_same, data_cfg, write_gt_database

ALL = ['car', 'truck', 'construction_vehicle', 'bus', 'trailer', 'barrier',
       'motorcycle', 'bicycle', 'pedestrian', 'traffic_cone']
KNOWN = ALL[:6]
ST_YAML = "tools/cfgs/nuscenes_models/transfusion_lidar_st.yaml"


def _boxes(rng, n, labels=(7, 8, 9, 10), spread=20.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 2.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return (b, rng.uniform(0.05, 1.0, n).astype(np.float32),
            rng.choice(labels, n).astype(np.int32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_written_by_one_read_by_the_other(tmp_path, writer):
    w, r = (TP, JP) if writer == "port" else (JP, TP)
    b, s, lab = _boxes(np.random.RandomState(0), 5)
    w.PseudoLabelStore(tmp_path).save(3, b, s, lab)
    w.PseudoLabelStore(tmp_path).stamp_epoch(4)
    store = r.PseudoLabelStore(tmp_path)
    assert_same(list(store.load(3)), [b, s, lab])
    assert store.stamped_epoch() == 4
    assert_same(list(store.load(9)),
                list(JP.PseudoLabelStore(tmp_path).load(9)))
    assert store.missing == {"9"}


def test_reverse_augmentation_and_bev_nms_match_jax():
    rng = np.random.RandomState(0)
    boxes = np.zeros((7, 9), np.float32)
    boxes[:, :7] = _boxes(rng, 7)[0]
    boxes[:, 7:9] = rng.uniform(-3, 3, (7, 2))
    records = [
        {},
        {"flip_x": 1.0, "flip_y": 0.0, "noise_rot": 0.4,
         "noise_scale": 1.05,
         "noise_translate": np.array([0.5, -0.2, 0.1], np.float32)},
        {"flip_x": 0.0, "flip_y": 1.0, "noise_rot": -0.7,
         "noise_scale": 0.93},
    ]
    for dd in records:
        for cols in (7, 9):
            assert_same(TP.reverse_augmentation(boxes[:, :cols], dd),
                        JP.reverse_augmentation(boxes[:, :cols], dd))
    b, s, _ = _boxes(rng, 40, spread=6.0)
    for thresh in (1e-7, 0.1, 0.5):
        assert_same(TP.bev_nms_cpu(b, s, thresh), JP.bev_nms_cpu(b, s,
                                                                 thresh))
    assert_same(TP.remove_empty(np.concatenate([b, b[:2] * 0])),
                JP.remove_empty(np.concatenate([b, b[:2] * 0])))


def _fill_stores(root, frames, seed=0):
    rng = np.random.RandomState(seed)
    for name in ("frustum", "st"):
        store = TP.PseudoLabelStore(root / name)
        for f in frames:
            store.save(f, *_boxes(rng, rng.randint(0, 9),
                                  labels=tuple(range(1, 11))))


@pytest.mark.parametrize("max_per_class", [None, 2])
def test_pseudo_loader_filters_match_jax(tmp_path, max_per_class):
    """The frustum and self-train loads over a sequence of frames (one
    missing), with the per-class EMA thresholds equal after every frame."""
    frames = list(range(6))
    _fill_stores(tmp_path, frames[:-1])
    kw = dict(pseudo_path=tmp_path / "frustum",
              self_train_path=tmp_path / "st", all_class_names=ALL,
              min_score=0.2, max_selftrain_per_class=max_per_class)
    t, j = TP.PseudoLoader(KNOWN, **kw), JP.PseudoLoader(KNOWN, **kw)
    rng = np.random.RandomState(1)
    n = 0
    for f in frames:
        gt = np.zeros((2, 8), np.float32)
        gt[:, :7] = _boxes(rng, 2)[0]
        dd = {"frame_id": f, "gt_boxes": gt}
        got = t.load_selftrain_pseudos(t.load_frustum_pseudos(dict(dd)))
        want = j.load_selftrain_pseudos(j.load_frustum_pseudos(dict(dd)))
        assert_same(got, want)
        assert_same(t.unknown_score_ema, j.unknown_score_ema)
        n += len(got["pseudo_boxes"])
    assert n > 0 and t.frustum_store.missing == {"5"}


def _sampler_frames(seed, n_frames=5):
    """Frames with clusters of points inside unknown-class pseudo boxes."""
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n_frames):
        k = rng.randint(2, 6)
        boxes = np.zeros((k, 8), np.float32)
        pts = []
        for i in range(k):
            c = np.array([rng.uniform(6, 30) * rng.choice([-1, 1]),
                          rng.uniform(-20, 20), 0.0], np.float32)
            boxes[i] = [*c, 2, 1.2, 1.5, rng.uniform(-3, 3),
                        rng.choice([7, 8, 9])]
            pts.append(c + rng.uniform(-0.4, 0.4, (rng.randint(2, 30), 3)))
        pts.append(rng.uniform(-40, 40, (400, 3)))
        pts = np.concatenate(pts).astype(np.float32)
        pts = np.concatenate([pts, rng.uniform(0, 1, (len(pts), 2))], 1
                             ).astype(np.float32)
        gt = np.array([[0, 20, 0, 4, 2, 1.5, 0.0, 1],
                       [0, -20, 0, 4, 2, 1.5, 0.0, 2]], np.float32)
        frames.append((pts, boxes, rng.uniform(0.1, 1, k).astype(np.float32),
                       gt))
    return frames


@pytest.mark.parametrize("metric,fix_cp", [("conf", None), ("num_pts", 3)])
def test_pseudo_sampler_matches_jax(metric, fix_cp):
    """Queues (with replacement at the size limit) and copy-paste over a
    sequence of frames, with equal draws."""
    kw = dict(min_pts=3, max_queue_size_per_class=3, queue_metric=metric)
    t = TP.PseudoSampler([7, 8, 9], [1, 2, 3, 4, 5, 6], **kw)
    j = JP.PseudoSampler([7, 8, 9], [1, 2, 3, 4, 5, 6], **kw)
    rng = np.random.RandomState(3)
    np.random.seed(3)
    pasted = 0
    for pts, boxes, scores, gt in _sampler_frames(0):
        dt, dj = {"points": pts.copy()}, {"points": pts.copy()}
        got = t(dt, boxes, scores, gt, fix_cp=fix_cp, rng=rng)
        want = j(dj, boxes, scores, gt, fix_cp=fix_cp)
        assert_same([got, dt], [want, dj])
        pasted += int(got[1].sum())
        assert_same(t.seen_per_class_ema, j.seen_per_class_ema)
        for lbl in t.unknown_queue:
            assert_same([(s.conf, s.points, s.label, s.ry)
                         for s in t.unknown_queue[lbl]],
                        [(s.conf, s.points, s.label, s.ry)
                         for s in j.unknown_queue[lbl]])
    assert pasted > 0
    assert max(len(q) for q in t.unknown_queue.values()) == 3


def test_pseudo_processor_matches_jax(tmp_path):
    """relabel_gt_boxes (knowns not a prefix of the full list),
    combine_gt_with_pseudos with its stats, and save_predictions (copy-paste
    overlaps dropped, augmentations inverted) into stores read back."""
    known = ['car', 'pedestrian', 'bicycle']
    t = TP.PseudoProcessor(known, self_training_folder=tmp_path / "t",
                           all_class_names=ALL)
    j = JP.PseudoProcessor(known, self_training_folder=tmp_path / "j",
                           all_class_names=ALL)
    rng = np.random.RandomState(0)
    gt = np.zeros((2, 5, 8), np.float32)
    gt[0, :3, :7] = _boxes(rng, 3)[0]
    gt[0, :3, 7] = [1, 2, 3]
    gt[1, :1, :7] = _boxes(rng, 1)[0]
    gt[1, 0, 7] = 2
    pseudo = np.zeros((2, 4, 8), np.float32)
    pseudo[0, :2, :7] = _boxes(rng, 2)[0]
    pseudo[0, :2, 7] = [4, 6]
    assert_same(t.relabel_gt_boxes(gt), j.relabel_gt_boxes(gt))
    assert_same(t.combine_gt_with_pseudos(t.relabel_gt_boxes(gt), pseudo),
                j.combine_gt_with_pseudos(j.relabel_gt_boxes(gt), pseudo))
    assert_same(t.forward_pseudo_stats, j.forward_pseudo_stats)
    dds, dets = [], []
    for f in range(3):
        b, s, lab = _boxes(rng, 6, spread=8.0)
        samples = np.zeros((3, 8), np.float32)
        samples[:, :7] = b[:3] + [0.1, 0, 0, 0, 0, 0, 0]
        dds.append({"frame_id": f, "pseudo_boxes": samples,
                    "pseudo_samples_mask": np.array([f == 1, True, False]),
                    "flip_x": float(f % 2), "noise_rot": 0.3 * f,
                    "noise_scale": 1.02,
                    "noise_translate": np.float32([0.1, 0.2, -0.1])})
        dets.append({"pred_boxes": b, "pred_scores": s, "pred_labels": lab})
    t.save_predictions(dds, dets)
    j.save_predictions(dds, dets)
    t.stamp_epoch(2)
    j.stamp_epoch(2)
    for f in range(3):
        assert_same(list(t.store.load(f)), list(j.store.load(f)))
    assert len(t.store.load(0)[0]) == 5
    assert t.store.stamped_epoch() == j.store.stamped_epoch() == 2


@pytest.fixture
def jax_hooks_restored():
    """register_pseudo_hooks of the reference writes a module-level dict:
    put it back as it was after the test."""
    saved = dict(jaug.EXTRA_AUGMENTORS)
    yield
    jaug.EXTRA_AUGMENTORS.clear()
    jaug.EXTRA_AUGMENTORS.update(saved)


def st_chain(tmp_path):
    """The ST yaml's augmentation list (gt_sampling, the three pseudo-label
    hooks, the four world augmentations) over small synthetic scenes of
    its known classes, with a gt database, a frustum store of unknown
    boxes centred on each frame's points and a self-train store."""
    st = cfg_from_yaml_file(ST_YAML)
    cfg = data_cfg(scenes=6, camera=False)
    cfg["POINT_CLOUD_RANGE"] = [-25.6, -25.6, -3.0, 25.6, 25.6, 1.0]
    cfg["SYNTHETIC"].update(NUM_OBJECTS=8, NUM_RAW_POINTS=6000)
    cfg["CAPACITIES"].update(MAX_POINTS=9000, MAX_GT=40, MAX_PSEUDO=12)
    cfg["DATA_PATH"] = str(tmp_path)
    cfg["DATA_AUGMENTOR"] = st.DATA_CONFIG.DATA_AUGMENTOR.copy()
    db_name = st.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST[0][
        "DB_INFO_PATH"][0]
    infos = write_gt_database(tmp_path, n_scenes=4, classes=KNOWN)
    with open(tmp_path / db_name, "wb") as f:
        pickle.dump(infos, f)
    ds = TD.SyntheticDataset(EDict(dict(cfg, DATA_AUGMENTOR=None)), KNOWN,
                             training=True)
    rng = np.random.RandomState(0)
    frustum = TP.PseudoLabelStore(tmp_path / "frustum")
    selftrain = TP.PseudoLabelStore(tmp_path / "st")
    for i in range(len(ds)):
        d = ds.generate_scene(i)
        boxes = []
        for _ in range(400):
            c = d["points"][rng.randint(len(d["points"])), :3]
            b = np.array([*c, 0.8, 0.7, 1.7, rng.uniform(-np.pi, np.pi)],
                         np.float32)
            if (TG.points_in_boxes_mask(d["points"][:, :3], b[None]).sum()
                    >= 2 and TG.boxes_bev_iou_cpu(
                        b[None], d["gt_boxes"]).max() == 0):
                boxes.append(b)
            if len(boxes) == 4:
                break
        boxes = np.array(boxes, np.float32).reshape(-1, 7)
        frustum.save(i, boxes, rng.uniform(0.3, 0.9, len(boxes)),
                     rng.choice([7, 8, 9, 10], len(boxes)).astype(np.int32))
        if i % 2 == 0:
            selftrain.save(i, *_boxes(rng, 5, labels=tuple(range(1, 11))))
    kw = dict(pseudo_path=tmp_path / "frustum",
              self_train_path=tmp_path / "st", all_class_names=ALL,
              sampler_kwargs={"min_pts": 2})
    return cfg, kw


def test_st_hook_chain_matches_jax(tmp_path, jax_hooks_restored):
    """The whole chain through build_dataloader in both packages: equal
    batches over two shuffled epochs, the copy-paste queues equal after."""
    cfg, kw = st_chain(tmp_path)
    jloader = JP.PseudoLoader(KNOWN, **kw)
    j_register(jloader)
    np.random.seed(0)
    _, jl, _ = JD.build_dataloader(JEDict(cfg), KNOWN, batch_size=2,
                                   training=True, seed=0, prefetch=0)
    tloader = TP.PseudoLoader(KNOWN, **kw)
    _, tl, _ = TD.build_dataloader(EDict(cfg), KNOWN, batch_size=2,
                                   training=True, seed=0, prefetch=2,
                                   hooks=t_register(tloader))
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert_same(got, want)
    assert all((b["pseudo_boxes"][..., 7] > 0).any() for b in got)
    assert any(((b["gt_boxes"][..., 7] > 0).sum(1) > 8).any() for b in got)
    assert any(b["pseudo_samples_mask"].any() for b in got)
    assert_same(tloader.unknown_score_ema, jloader.unknown_score_ema)
    for lbl in tloader.sampler.unknown_queue:
        assert_same([(s.conf, s.points) for s in
                     tloader.sampler.unknown_queue[lbl]],
                    [(s.conf, s.points) for s in
                     jloader.sampler.unknown_queue[lbl]])


def test_two_datasets_do_not_share_hooks(tmp_path):
    """Hooks go to the dataset they are handed to: a second dataset built
    in the same process without them has none, and refuses a config that
    names them; the copy-paste step draws from its own dataset's rng."""
    cfg, kw = st_chain(tmp_path)
    hooks = t_register(TP.PseudoLoader(KNOWN, **kw))
    ds, _, _ = TD.build_dataloader(EDict(cfg), KNOWN, batch_size=2,
                                   hooks=hooks, prefetch=0)
    world = dict(cfg, DATA_AUGMENTOR={"AUG_CONFIG_LIST": [
        a for a in cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]
        if a["NAME"].startswith("random_world")]})
    plain, _, _ = TD.build_dataloader(EDict(world), KNOWN, batch_size=2,
                                      prefetch=0)
    assert len(ds.data_augmentor.queue) == 8
    assert len(plain.data_augmentor.queue) == 4 and not \
        plain.data_augmentor.hooks
    assert "pseudo_boxes" not in plain[0]
    with pytest.raises(ValueError, match="load_frustum_pseudos"):
        TD.build_dataloader(EDict(cfg), KNOWN, batch_size=2, prefetch=0)
    paste = ds.data_augmentor.queue[3]
    assert paste.keywords["rng"] is ds.rng and plain.rng is not ds.rng
