"""The port's last small CLIs on the CPU: tools/demo.py with
visual_utils/pyplot_vis_utils.py, tools/test_clip_crops.py and
tools/process_tools/create_integrated_database.py.

The demo runs the narrow TransFusion of tests/test_torch_transfusion.py
over .bin files written from lidar_ring scenes; its detections must equal
the eval step's on the same scenes from the synthetic dataset, exactly
(one process, the same weights and arithmetic). The port's
pyplot_vis_utils passes tests/test_pyplot_vis.py's cases and draws the
same PNG as the JAX package's copy. test_clip_crops' stub classifier
gives the same labels as the reference's on the same camera rig, and the
integrated database is byte for byte the JAX script's.
"""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network
from findnpropagate_torch.runtime.trainer import make_eval_step
from findnpropagate_torch.tools import demo
from findnpropagate_torch.tools import test_clip_crops as clip_cli
from findnpropagate_torch.tools.process_tools import (
    create_integrated_database as cid,
)
from findnpropagate_torch.tools.visual_utils import pyplot_vis_utils as vis
from findnpropagate_torch.utils.weights import init_random_
from test_pyplot_vis import _scene
from test_torch_transfusion import DATA, narrow_cfg

REPO = Path(__file__).resolve().parent.parent
PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_yaml(path, data=None):
    """The narrow TransFusion over `data` (the synthetic DATA) as a yaml
    the CLIs read."""
    cfg = narrow_cfg()
    plain = json.loads(json.dumps({"CLASS_NAMES": list(cfg.CLASS_NAMES),
                                   "DATA_CONFIG": data or DATA,
                                   "MODEL": cfg.MODEL,
                                   "OPTIMIZATION": cfg.OPTIMIZATION}))
    path.write_text(yaml.safe_dump(plain))
    return path


# ------------------------------------------------------------------ demo

@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("demo")
    cfg_file = write_yaml(work / "narrow.yaml")
    tds = SyntheticDataset(EDict(DATA), narrow_cfg().CLASS_NAMES,
                           training=False)
    bins = work / "bins"
    bins.mkdir()
    for i in range(2):
        pts = tds.generate_scene(i)["points"]
        ring = np.zeros((len(pts), 1), np.float32)
        np.concatenate([pts, ring], 1).astype(np.float32).tofile(
            bins / f"{i:06d}.bin")
    found = {mode: demo.main(["--cfg_file", str(cfg_file), "--data_path",
                              str(bins), "--out_dir", str(work / mode),
                              "--mode", mode, "--device", "cpu"])
             for mode in ("bev", "3d")}
    return work, tds, found


def test_demo_detections_equal_the_eval_step(demo_run):
    _, tds, found = demo_run
    det = build_network(narrow_cfg().MODEL, num_class=10, dataset=tds,
                        device="cpu")
    init_random_(det, seed=0)
    step = make_eval_step(det)
    for i in range(2):
        batch = tds.collate_batch([tds[i]])
        batch.pop("frame_id")
        batch.pop("batch_size")
        dets = step({k: torch.as_tensor(v) for k, v in batch.items()})
        n = int(dets.count[0])
        assert n > 0
        for mode in ("bev", "3d"):
            boxes, scores, labels = found[mode][f"{i:06d}"]
            np.testing.assert_array_equal(boxes, dets.boxes[0, :n].numpy())
            np.testing.assert_array_equal(scores, dets.scores[0, :n].numpy())
            np.testing.assert_array_equal(labels, dets.labels[0, :n].numpy())


@pytest.mark.parametrize("mode", ["bev", "3d"])
def test_demo_writes_a_png_per_file(demo_run, mode):
    work = demo_run[0]
    pngs = sorted((work / mode).glob("*.png"))
    assert [p.stem for p in pngs] == ["000000", "000001"]
    for p in pngs:
        data = p.read_bytes()
        assert data[:8] == PNG and len(data) > 20000


# ------------------------------------------------------- pyplot_vis_utils

def test_draw_scenes_builds_3d_figure():
    pts, gt, pred, scores, labels = _scene()
    fig = vis.draw_scenes(pts, gt_boxes=gt, ref_boxes=pred,
                          ref_scores=scores, ref_labels=labels)
    ax = fig.gca()
    assert ax.name == "3d"
    assert len(ax.collections) >= 4
    import matplotlib.pyplot as plt

    plt.close(fig)


def test_save_scene_writes_the_reference_png(tmp_path):
    """The port's scene is the JAX package's copy's, byte for byte."""
    sys.path.insert(0, str(REPO / "tools"))
    from visual_utils import pyplot_vis_utils as ref

    pts, gt, pred, scores, labels = _scene()
    kw = dict(gt_boxes=gt, ref_boxes=pred, ref_scores=scores,
              ref_labels=labels)
    out = vis.save_scene(tmp_path / "scene.png", pts, **kw)
    want = ref.save_scene(tmp_path / "ref.png", pts, **kw)
    data = Path(out).read_bytes()
    assert data[:8] == PNG and len(data) > 20000
    assert data == Path(want).read_bytes()


def test_draw_scenes_handles_empty_predictions(tmp_path):
    pts, gt, _, _, _ = _scene()
    out = vis.save_scene(tmp_path / "empty.png", pts, gt_boxes=gt,
                         ref_boxes=np.zeros((0, 7), np.float32),
                         ref_scores=np.zeros((0,), np.float32),
                         ref_labels=np.zeros((0,), np.int64))
    assert Path(out).exists()


# ------------------------------------------------------- test_clip_crops

def test_clip_crops_stub_runs_and_finds_no_images(tmp_path):
    """As the reference's, the CLI finds no `images` in the repository's
    datasets: every sample is skipped and the accuracy is over no box."""
    cfg_file = write_yaml(tmp_path / "narrow.yaml")
    correct, total = clip_cli.main(["--cfg_file", str(cfg_file), "--stub",
                                    "--max_samples", "2", "--device",
                                    "cpu"])
    assert total.sum() == 0 and correct.sum() == 0


def test_clip_crops_stub_scores_like_the_reference(tmp_path):
    """The stub's labels on a camera rig of the synthetic dataset, through
    score_batch, equal the reference's stub relabel of the same boxes."""
    import jax.numpy as jnp
    from findnpropagate_tpu.openvocab.box_classification import (
        CLIPBoxClassification as JaxCLIP,
    )

    data = json.loads(json.dumps(DATA))
    data["SYNTHETIC"]["CAMERA"] = {"NUM": 2, "IMAGE_SIZE": [96, 160]}
    data["SYNTHETIC"]["NUM_OBJECTS"] = 6
    names = list(narrow_cfg().CLASS_NAMES)
    tds = SyntheticDataset(EDict(data), names, training=False)
    b = tds.collate_batch([tds[0]])
    batch = {"gt_boxes": b["gt_boxes"], "images": b["camera_imgs"],
             "trans_lidar_to_image": b["lidar2image"]}
    clip = clip_cli.stub_classifier(names, "cpu")
    clip.image_size = (96, 160)
    correct = np.zeros(len(names), np.int64)
    total = np.zeros(len(names), np.int64)
    assert clip_cli.score_batch(clip, batch, correct, total, "cpu",
                                save_dir=tmp_path / "grids",
                                class_names=names) == 1
    assert total.sum() == 6
    assert len(list((tmp_path / "grids").glob("crops_*.png"))) == 1

    class JaxStub:
        def get_image_features(self, pixel_values):
            return jnp.mean(jnp.asarray(pixel_values), axis=(2, 3))

    ref = JaxCLIP(class_names=names, image_size=(96, 160))
    ref._model = JaxStub()
    ref._text_features = jnp.asarray(clip._text_features.numpy())
    gt = b["gt_boxes"][0]
    boxes = gt[gt[:, 3] > 0][:, :7]
    want, _ = ref.relabel(jnp.asarray(boxes), jnp.asarray(
        b["lidar2image"][0]), jnp.asarray(b["camera_imgs"][0]))
    got, _ = clip.relabel(torch.from_numpy(boxes),
                          torch.from_numpy(b["lidar2image"][0]),
                          torch.from_numpy(b["camera_imgs"][0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    labels = gt[gt[:, 3] > 0][:, -1].astype(np.int64)
    hits = (np.asarray(want) == labels)
    for c in range(len(names)):
        assert correct[c] == hits[labels == c + 1].sum()


# ---------------------------------------------- create_integrated_database

def write_db(root):
    rng = np.random.RandomState(0)
    infos = {}
    for name, n in (("car", 3), ("pedestrian", 2)):
        for i in range(n):
            rel = f"gt_database/{name}_{i}.bin"
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            rng.standard_normal((rng.randint(1, 40), 5)).astype(
                np.float32).tofile(root / rel)
            infos.setdefault(name, []).append({"path": rel, "name": name})
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    return root / "dbinfos.pkl"


def test_integrated_database_equals_the_reference(tmp_path, monkeypatch):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for root in (ours, theirs):
        root.mkdir()
        write_db(root)
    cid.main(["--src_db_info", str(ours / "dbinfos.pkl"), "--root_path",
              str(ours), "--dst_db_info", str(ours / "out.pkl")])

    spec = importlib.util.spec_from_file_location(
        "jax_cid", REPO / "tools/process_tools/create_integrated_database.py")
    jax_cid = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cid)
    monkeypatch.setattr(sys, "argv", [
        "create_integrated_database.py", "--src_db_info",
        str(theirs / "dbinfos.pkl"), "--root_path", str(theirs),
        "--dst_db_info", str(theirs / "out.pkl")])
    jax_cid.main()

    name = "gt_database_global.npy"
    assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    with open(ours / "out.pkl", "rb") as f:
        got = pickle.load(f)
    with open(theirs / "out.pkl", "rb") as f:
        want = pickle.load(f)
    assert got == want
    assert got["pedestrian"][-1]["global_data_offset"][1] == len(
        np.load(ours / name))
