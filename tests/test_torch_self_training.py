"""The port's self-training path ("Propagate") and the extraction CLI
("Find") on the CPU: findnpropagate_torch/tools/train_st.py through
openvocab/self_training.py and runtime/trainer.py::make_eval_step, and
findnpropagate_torch/tools/extract_pseudo_labels.py over the seekers.
The numpy layers under them are held against the JAX package in
tests/test_torch_datasets.py and tests/test_torch_pseudo_labels.py, the
model in tests/test_torch_transfusion*.py; here the run as a whole."""

import copy
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from findnpropagate_torch import config as cfg_mod
from findnpropagate_torch.datasets import build_dataloader
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network
from findnpropagate_torch.openvocab.alt_proposers import (
    ALT_PROPOSER_REGISTRY,
)
from findnpropagate_torch.models.dense_heads.transfusion_head import (
    TransFusionHead,
)
from findnpropagate_torch.openvocab.preprocessed_detector import (
    CAMERA_NAMES,
    PreprocessedDetector,
)
from findnpropagate_torch.openvocab.pseudo_labels import (
    PseudoLabelStore,
    PseudoProcessor,
)
from findnpropagate_torch.openvocab.self_training import (
    extract_pseudo_labels,
)
from findnpropagate_torch.runtime.trainer import make_eval_step
from findnpropagate_torch.tools import extract_pseudo_labels as cli_ex
from findnpropagate_torch.tools import train_st
from findnpropagate_torch.utils import geometry_np as G
from findnpropagate_torch.utils.weights import init_random_
from test_torch_seeker import ring_rig, ring_scene
from test_torch_seeker_variants import kitti_inputs
from test_torch_transfusion import DATA, narrow_cfg

ROOT = Path(__file__).resolve().parents[1]
SYNTH_ST = ROOT / "tools/cfgs/synthetic_models/transfusion_synth_st.yaml"
NUSC_SEEKER = ROOT / ("tools/cfgs/nuscenes_models/"
                      "nuscenes_box_seeker_proposals.yaml")
KITTI_SEEKER = ROOT / "tools/cfgs/kitti_models/kitti_box_seeker_proposals.yaml"
# the windowed posgather backbone of transfusion_lidar.yaml, whose kernels
# the card runs (the yaml's own gather backbone: test_train_st_runs_the_
# gather_backbone)
WINDOWED = ["MODEL.BACKBONE_3D.SUBM_MODE", "windowed",
            "MODEL.BACKBONE_3D.SUBM_IMPL", "posgather",
            "MODEL.BACKBONE_3D.WINDOWED_BLOCK", "512"]
# narrow widths (tests/test_torch_transfusion.py's) for a short CPU run
NARROW = ["MODEL.BACKBONE_3D.CHANNELS", "[16,16,16,16,16]",
          "MODEL.BACKBONE_3D.OUT_CHANNELS", "16",
          "MODEL.MAP_TO_BEV.NUM_BEV_FEATURES", "32",
          "MODEL.BACKBONE_2D.LAYER_NUMS", "[1,1]",
          "MODEL.BACKBONE_2D.NUM_FILTERS", "[16,32]",
          "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16,16]",
          "MODEL.DENSE_HEAD.HIDDEN_CHANNEL", "32",
          "MODEL.DENSE_HEAD.NUM_HEADS", "2",
          "MODEL.DENSE_HEAD.FFN_CHANNEL", "64"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small ops, and under a
    parallel test run the threads of several processes oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seed_frustum_store(path, cfg_file=SYNTH_ST, per_frame=3, min_pts=5):
    """Unknown-class boxes (pedestrian size) centred on points of each
    training frame, holding at least `min_pts` points and overlapping no
    ground truth; numpy seed 0."""
    cfg = cfg_mod.cfg_from_yaml_file(str(cfg_file))
    ds = SyntheticDataset(cfg_mod.EDict(cfg.DATA_CONFIG, DATA_AUGMENTOR=None),
                          cfg.CLASS_NAMES, training=True)
    unknown = [i + 1 for i, n in enumerate(cfg.FULL_CLASS_NAMES)
               if n not in cfg.KNOWN_CLASS_NAMES]
    store = PseudoLabelStore(path)
    rng = np.random.RandomState(0)
    for i in range(len(ds)):
        d = ds.generate_scene(i)
        pts, boxes = d["points"], []
        for _ in range(4000):
            c = pts[rng.randint(len(pts)), :3]
            b = np.array([*c, 0.8, 0.7, 1.7, rng.uniform(-np.pi, np.pi)],
                         np.float32)
            if (G.points_in_boxes_mask(pts[:, :3], b[None]).sum() >= min_pts
                    and G.boxes_bev_iou_cpu(b[None],
                                            d["gt_boxes"]).max() == 0):
                boxes.append(b)
                if len(boxes) == per_frame:
                    break
        store.save(i, np.array(boxes, np.float32).reshape(-1, 7),
                   rng.uniform(0.3, 0.9, len(boxes)).astype(np.float32),
                   rng.choice(unknown, len(boxes)).astype(np.int32))
    return len(ds)


def test_train_st_runs_warmup_extraction_and_self_training(tmp_path,
                                                            monkeypatch):
    """Two epochs with st_warmup 1 through the CLI's main: epoch 0 trains
    on the frustum labels, epoch 1 extracts into the self-train store
    (every frame, stamped 1) and trains on both; the unknown class reaches
    the head's targets in both epochs, the loss stays finite."""
    frames = seed_frustum_store(tmp_path / "frustum")
    unknown_targets = []
    orig = TransFusionHead.get_targets

    def get_targets(self, res, gt):
        t = orig(self, res, gt)
        unknown_targets.append(int(t["unknown_mask"].sum()))
        return t

    monkeypatch.setattr(TransFusionHead, "get_targets", get_targets)
    monkeypatch.chdir(tmp_path)
    steps = []
    run = train_st.self_training.train_model_st

    def spy(*a, **kw):
        steps.extend(run(*a, **dict(kw, log_interval=1)))
        return steps

    monkeypatch.setattr(train_st.self_training, "train_model_st", spy)
    rc = train_st.main([
        "--cfg_file", str(SYNTH_ST), "--epochs", "2", "--st_warmup", "1",
        "--pseudo_path", str(tmp_path / "frustum"), "--st_path",
        str(tmp_path / "st"), "--seed", "0", "--device", "cpu",
        "--set", *WINDOWED, *NARROW])
    assert rc == 0
    out = tmp_path / "output" / "synthetic_models" / "transfusion_synth_st"
    log = next((out / "default").glob("log_train_st_*.txt")).read_text()
    assert re.search(rf"extracted pseudo labels for {frames} frames", log)
    assert "self-training done" in log
    st = PseudoLabelStore(tmp_path / "st")
    assert st.stamped_epoch() == 1
    assert len(list((tmp_path / "st").glob("*.npz"))) == frames
    assert [s["epoch"] for s in steps] == [0] * 4 + [1] * 4
    assert all(math.isfinite(s["loss"]) and s["sparse_window_overflow"] == 0
               for s in steps)
    assert len(unknown_targets) == 8 and all(n > 0 for n in unknown_targets)
    assert sorted(p.name for p in (out / "default" / "ckpt").glob("*.pt")) \
        == ["checkpoint_1.pt", "checkpoint_2.pt"]


def test_train_st_runs_the_gather_backbone(tmp_path, monkeypatch):
    """The ST yaml as written names the gather backbone (and the synthetic
    dataset), which the port runs. One training step through the
    CLI's main with no --set on MODEL.BACKBONE_3D or DATA_CONFIG.DATASET
    (2 scenes at batch 2): the backbone runs in gather mode, the loss is
    finite and the overflow 0."""
    seed_frustum_store(tmp_path / "frustum")
    monkeypatch.chdir(tmp_path)
    built, steps = [], []
    build, run = train_st.build_network, train_st.self_training.train_model_st

    def build_spy(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    def run_spy(*a, **kw):
        steps.extend(run(*a, **dict(kw, log_interval=1)))
        return steps

    monkeypatch.setattr(train_st, "build_network", build_spy)
    monkeypatch.setattr(train_st.self_training, "train_model_st", run_spy)
    rc = train_st.main([
        "--cfg_file", str(SYNTH_ST), "--epochs", "1", "--batch_size", "2",
        "--pseudo_path", str(tmp_path / "frustum"), "--seed", "0",
        "--device", "cpu", "--set", "DATA_CONFIG.SYNTHETIC.NUM_SCENES", "2"])
    assert rc == 0
    bb = built[0].backbone_3d
    assert not bb.windowed and bb.impl == "xla"
    assert len(steps) == 1
    assert math.isfinite(steps[0]["loss"])
    assert steps[0]["sparse_window_overflow"] == 0


def narrow_detector():
    cfg = narrow_cfg()
    ds = SyntheticDataset(cfg_mod.EDict(DATA), cfg.CLASS_NAMES,
                          training=False)
    det = build_network(copy.deepcopy(cfg.MODEL), 10, ds, device="cpu")
    init_random_(det, seed=0)
    return det, ds


def buffers(det):
    return {k: v.clone() for k, v in det.named_buffers()}


@pytest.mark.parametrize("training", [True, False])
def test_eval_step_restores_mode_and_bn_statistics(training):
    """make_eval_step runs in eval mode under no_grad and leaves the
    module in the mode it found, BN running statistics untouched; its
    detections equal an eval forward's."""
    det, ds = narrow_detector()
    batch = {k: torch.from_numpy(v) for k, v in ds.batch(range(2)).items()}
    det.train(training)
    before = buffers(det)
    dets, overflow = make_eval_step(det, with_overflow=True)(batch)
    assert det.training == training
    for k, v in buffers(det).items():
        assert torch.equal(v, before[k]), k
    assert int(overflow) == 0 and not dets.boxes.requires_grad
    det.eval()
    with torch.no_grad():
        want = det.post_process(det(batch))
    for a, b in zip(dets, want):
        assert torch.equal(a, b)


def test_extract_pseudo_labels_saves_every_frame(tmp_path):
    """The in-loop extraction over an inference loader: one file per
    frame holding the frame's detections, the epoch stamped, the module
    back in training mode with its BN statistics unchanged."""
    det, ds = narrow_detector()
    _, loader, _ = build_dataloader(cfg_mod.EDict(DATA), ds.class_names,
                                    batch_size=2, training=False)
    proc = PseudoProcessor(["car"], self_training_folder=tmp_path,
                           all_class_names=list(ds.class_names))
    det.train()
    before = buffers(det)
    assert extract_pseudo_labels(det, loader, proc, epoch=3) == 2
    assert det.training and proc.store.stamped_epoch() == 3
    for k, v in buffers(det).items():
        assert torch.equal(v, before[k]), k
    want = make_eval_step(det)({k: torch.from_numpy(v) for k, v in
                                ds.batch(range(2)).items()})
    for i in range(2):
        k = int(want.count[i])
        b, s, lab = proc.store.load(i)
        np.testing.assert_array_equal(b, want.boxes[i, :k].numpy())
        np.testing.assert_array_equal(s, want.scores[i, :k].numpy())
        np.testing.assert_array_equal(lab, want.labels[i, :k].numpy())


def write_coco(path, image, class_names, boxes_xyxy, labels, scores):
    """One COCO file in the detector's default xywh boxes."""
    xywh = np.concatenate([boxes_xyxy[:, :2],
                           boxes_xyxy[:, 2:] - boxes_xyxy[:, :2]], 1)
    path.write_text(json.dumps({
        "images": [{"id": 1, "file_name": image}],
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(class_names)],
        "annotations": [{"image_id": 1, "bbox": [float(v) for v in b],
                         "category_id": int(lb), "score": float(s)}
                        for b, lb, s in zip(xywh, labels, scores)]}))


class Frames:
    """A dataset of ready-made frames with the keys the extraction loop
    reads: no dataset of the repo gives `camera_paths`, and only a KITTI
    one `calib`."""

    def __init__(self, frames, max_points):
        self.frames, self.max_points = frames, max_points

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


def nuscenes_frames(tmp_path, class_names):
    l2i, c2l, intr = ring_rig()
    frames, paths = [], {n: [] for n in CAMERA_NAMES}
    for f in range(2):
        sc = ring_scene(seed=f, n_points=5000, n_dets=12)
        images = [f"samples/{n}/frame{f}__{n}.jpg" for n in CAMERA_NAMES]
        for c, name in enumerate(CAMERA_NAMES):
            sel = sc["det_cams"] == c
            p = tmp_path / f"{name}_{f}.json"
            write_coco(p, images[c], class_names, sc["det_boxes"][sel],
                       sc["det_labels"][sel], sc["det_scores"][sel])
            paths[name].append(p)
        frames.append({"points": np.concatenate(
            [sc["points"], np.ones((5000, 1), np.float32)], 1),
            "frame_id": f"scene{f}", "camera_paths": images,
            "lidar2image": l2i, "camera2lidar": c2l,
            "camera_intrinsics": intr,
            "gt_boxes": np.array([[5.0, 3.0, -1.0, 4.0, 2.0, 1.5, 0.2, 1]],
                                 np.float32)})
    return frames, [p for n in CAMERA_NAMES for p in paths[n]]


def kitti_frames(tmp_path, class_names):
    pts, _, db, lab, sc, mask, P2, R0, V2C = kitti_inputs()
    p = tmp_path / "kitti.json"
    write_coco(p, "000042.png", class_names, db[mask], lab[mask], sc[mask])
    return [{"points": pts, "frame_id": "000042",
             "calib": {"P2": P2, "R0": R0, "V2C": V2C}}], [p]


@pytest.mark.parametrize("mode", ["nuscenes", "kitti"])
def test_extraction_loop_stores_the_seekers_valid_proposals(tmp_path, mode):
    """extract_frames over a test-local dataset stores, per frame, exactly
    the valid boxes, scores and labels of the seeker's propose on the
    padded frame and the frame's detections."""
    yaml = NUSC_SEEKER if mode == "nuscenes" else KITTI_SEEKER
    cfg = cfg_mod.cfg_from_yaml_file(str(yaml))
    seeker, kitti = cli_ex.build_seeker(cfg.MODEL.DENSE_HEAD,
                                        cfg.CLASS_NAMES)
    assert kitti == (mode == "kitti")
    make = nuscenes_frames if mode == "nuscenes" else kitti_frames
    frames, paths = make(tmp_path, cfg.CLASS_NAMES)
    detector2d = PreprocessedDetector(paths, cfg.CLASS_NAMES)
    store = PseudoLabelStore(tmp_path / "store")
    p = 6000 if mode == "nuscenes" else 40000
    recalls, total = cli_ex.extract_frames(Frames(frames, p), seeker,
                                           detector2d, store,
                                           kitti_mode=kitti, device="cpu")
    n_valid = 0
    for data in frames:
        pts = np.zeros((p, 3), np.float32)
        pts[:len(data["points"])] = data["points"][:, :3]
        pmask = np.arange(p) < len(data["points"])
        if kitti:
            d = detector2d.infer_kitti(data["frame_id"])
            c = data["calib"]
            out = seeker.propose(pts, pmask, d["det_boxes"], d["det_labels"],
                                 d["det_scores"], d["det_mask"], c["P2"],
                                 c["R0"], c["V2C"], device="cpu")
        else:
            d = detector2d.infer(data["camera_paths"])
            out = seeker.propose(pts, pmask, *[d[k] for k in (
                "det_boxes", "det_labels", "det_scores", "det_cams",
                "det_mask")], data["lidar2image"], data["camera2lidar"],
                data["camera_intrinsics"], device="cpu")
        v = out.valid.numpy()
        n_valid += int(v.sum())
        for got, want in zip(store.load(data["frame_id"]),
                             (out.boxes, out.scores, out.labels)):
            np.testing.assert_array_equal(got, want.numpy()[v])
    assert n_valid > 0
    assert total == (2 if mode == "nuscenes" else 0) and recalls <= total


def test_extraction_main_on_synthetic_frames(tmp_path):
    """main over the synthetic split: a file per frame and the epoch-0
    stamp; the frames carry no camera_paths (no dataset of the repo gives
    them), so no detection is found and every file is empty."""
    cfg = cfg_mod.cfg_from_yaml_file(str(NUSC_SEEKER))
    coco = tmp_path / "cam.json"
    write_coco(coco, "x.jpg", cfg.CLASS_NAMES, np.zeros((0, 4)), [], [])
    data = copy.deepcopy(DATA)
    data["SYNTHETIC"]["CAMERA"] = {"NUM": 6, "IMAGE_SIZE": [8, 8]}
    yaml_cfg = {"CLASS_NAMES": list(cfg.CLASS_NAMES), "DATA_CONFIG": data,
                "MODEL": {"NAME": "TransFusion", "DENSE_HEAD": dict(
                    cfg.MODEL.DENSE_HEAD, PREDS_PATHS=[str(coco)])}}
    path = tmp_path / "seeker.yaml"
    path.write_text(json.dumps(yaml_cfg))
    rc = cli_ex.main(["--cfg_file", str(path), "--save_path",
                      str(tmp_path / "out"), "--device", "cpu"])
    store = PseudoLabelStore(tmp_path / "out")
    assert rc == 0 and store.stamped_epoch() == 0
    assert all(len(store.load(i)[0]) == 0 for i in range(2))
    assert len(list((tmp_path / "out").glob("*.npz"))) == 2


def alt_main(tmp_path, name):
    """The extraction CLI's main in alt mode over the synthetic split,
    with one empty COCO file as PREDS_PATHS: (rc, store)."""
    coco = tmp_path / "cam.json"
    write_coco(coco, "x.jpg", ["car"], np.zeros((0, 4)), [], [])
    head = {"NAME": name, "PREDS_PATHS": [str(coco)]}
    data = copy.deepcopy(DATA)
    data["SYNTHETIC"]["CAMERA"] = {"NUM": 6, "IMAGE_SIZE": [8, 8]}
    cfg = {"CLASS_NAMES": ["car"], "DATA_CONFIG": data,
           "MODEL": {"DENSE_HEAD": head}}
    path = tmp_path / "alt.yaml"
    path.write_text(json.dumps(cfg))
    rc = cli_ex.main(["--cfg_file", str(path), "--save_path",
                      str(tmp_path / "out"), "--device", "cpu"])
    return rc, PseudoLabelStore(tmp_path / "out")


def test_extraction_alt_mode_is_not_ported(tmp_path):
    """Alt mode is ported (the name is kept from when it raised): FGR, an
    ablation proposer, runs through main and stores every frame."""
    rc, store = alt_main(tmp_path, "FGR")
    assert rc == 0 and store.stamped_epoch() == 0
    assert len(list((tmp_path / "out").glob("*.npz"))) == 2


@pytest.mark.parametrize("name", list(ALT_PROPOSER_REGISTRY))
def test_extraction_main_accepts_every_alt_proposer(tmp_path, name):
    """main runs every name of ALT_PROPOSER_REGISTRY: GTProposals stores
    each frame's ground truth; CLIP2Scene skips the synthetic frames (no
    point_seg_labels); the others propose from the frames' 2D detections
    (none here, no dataset of the repo gives camera_paths)."""
    rc, store = alt_main(tmp_path, name)
    files = list((tmp_path / "out").glob("*.npz"))
    assert rc == 0 and store.stamped_epoch() == 0
    if name.startswith("CLIP2Scene"):
        assert not files
        return
    assert len(files) == 2
    data = copy.deepcopy(DATA)
    data["SYNTHETIC"]["CAMERA"] = {"NUM": 6, "IMAGE_SIZE": [8, 8]}
    ds = SyntheticDataset(cfg_mod.EDict(data), ["car"], training=True)
    for i in range(2):
        boxes, scores, labels = store.load(i)
        if name == "GTProposals":
            gt = ds[i]["gt_boxes"]
            np.testing.assert_array_equal(boxes, gt[:, :7])
            np.testing.assert_array_equal(labels, gt[:, 7].astype(int))
            assert len(boxes) > 0
        else:
            assert len(boxes) == 0


@pytest.mark.parametrize("cli", ["train_st", "extract_pseudo_labels"])
def test_clis_raise_without_cuda_and_device(tmp_path, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    args = (["--cfg_file", str(SYNTH_ST)] if cli == "train_st" else
            ["--cfg_file", str(NUSC_SEEKER), "--save_path", "out"])
    main = train_st.main if cli == "train_st" else cli_ex.main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)
