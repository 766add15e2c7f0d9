"""The port's VLM relabelers (findnpropagate_torch/openvocab/
box_classification.py, models/backbones_image/maskclip.py) and
self_training.build_relabeler against the JAX package's, on the CPU.

The CLIP encoders need weights that are not in the repository, so both
packages get seeded stand-ins for the encoder alone (the reference's own
tests stub them too: tests/test_box_classification.py::_StubCLIP,
tests/test_alt_proposers.py::_StubMaskCLIP); the projection, the crops,
the normalisation, the softmax, the resize and the per-box means are the
packages' own. Tolerances: 2D boxes within 1e-3 px (the projection's f32
products summed in another order), crop indices bit-equal given the same
2D boxes, per-pixel probabilities within 1e-5, labels equal and scores
within 1e-5 unless the two packages' scores of a box differ by no more
than that (two classes within the tolerance; printed with the gap)."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch import config as cfg_mod
from findnpropagate_torch.datasets import build_dataloader
from findnpropagate_torch.models.backbones_image.maskclip import MaskCLIP
from findnpropagate_torch.openvocab import box_classification as tbc
from findnpropagate_torch.openvocab import self_training as tst
from findnpropagate_torch.openvocab.preprocessed_detector import (
    CAMERA_NAMES,
    PreprocessedDetector,
)
from findnpropagate_torch.openvocab.pseudo_labels import PseudoProcessor
from findnpropagate_tpu.models.backbones_image import maskclip as jmc
from findnpropagate_tpu.openvocab import box_classification as jbc
from findnpropagate_tpu.openvocab import self_training as jst
from test_box_classification import BOXES3D, project_box_2d
from test_frustum_proposer import make_camera
from test_torch_seeker import random_boxes, ring_rig
from test_torch_self_training import narrow_detector
from test_torch_transfusion import DATA

TOL = 1e-5
PX_ATOL = 1e-3
H, W = 900, 1600


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x))


def hold_relabel(got, want, tol=TOL):
    """Labels equal and scores within tol, but for boxes whose scores in
    the two packages lie within tol (their two best classes tie within
    it); those are printed with the gap."""
    gl, gs = (np.asarray(x) for x in got)
    wl, ws = (np.asarray(x) for x in want)
    gap = np.abs(gs - ws)
    assert (gap <= tol).all(), gap.max()
    for b in np.flatnonzero(gl != wl):
        print(f"box {b}: label {gl[b]} here, {wl[b]} in the reference; "
              f"scores {gs[b]:.7f} / {ws[b]:.7f}")
    assert ((gl == wl) | (gap <= tol)).all()
    return int((gl != wl).sum())


def scene_boxes(seed, n):
    """n boxes around the ego vehicle (some behind each camera)."""
    rng = np.random.RandomState(seed)
    b = random_boxes(rng, n, spread=25.0)
    return np.concatenate([BOXES3D, b]).astype(np.float32)


def test_project_boxes_to_cameras_matches_reference():
    l2i, _, _ = ring_rig()
    boxes = scene_boxes(0, 30)
    got = tbc.project_boxes_to_cameras(t(boxes), t(l2i))
    want = jbc.project_boxes_to_cameras(jnp.asarray(boxes), jnp.asarray(l2i))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    vis = got[1].numpy()
    np.testing.assert_allclose(got[0].numpy()[vis], np.asarray(want[0])[vis],
                               atol=PX_ATOL, rtol=0)
    assert vis.any() and not vis.all()
    # the reference's test: exact on a box in front, none behind
    cam, _, _ = make_camera()
    b2d, v = tbc.project_boxes_to_cameras(t(BOXES3D), t(cam[None]).float())
    assert v.all()
    for i in range(2):
        np.testing.assert_allclose(
            b2d[0, i].numpy(), project_box_2d(BOXES3D[i].astype(np.float64),
                                              cam), atol=0.5)
    behind = torch.tensor([[-10.0, 0, 0, 4, 2, 1.6, 0]])
    assert not tbc.project_boxes_to_cameras(
        behind, t(cam[None]).float())[1].any()


# ------------------------------------------------------------------- GLIP

def glip_inputs(case):
    if case in ("cached", "other_camera"):
        cam, _, _ = make_camera()
        boxes = BOXES3D if case == "cached" else BOXES3D[:1]
        i = [0, 1] if case == "cached" else [0, 0]
        dets = np.stack([project_box_2d(BOXES3D[k].astype(np.float64), cam)
                         for k in i])
        labels = np.int32([3, 7] if case == "cached" else [4, 9])
        scores = np.float32([0.8, 0.6] if case == "cached" else [0.5, 0.99])
        cams = np.int32([0, 0] if case == "cached" else [0, 5])
        return (boxes, cam[None].astype(np.float32), dets, labels, scores,
                cams, np.ones(2, bool))
    # the 6-camera ring, random detections, padding rows
    rng = np.random.RandomState(5)
    l2i, _, _ = ring_rig()
    boxes = scene_boxes(1, 40)
    d = 48
    dets = np.zeros((d, 4), np.float32)
    dets[:, 0] = rng.uniform(0, 1400, d)
    dets[:, 1] = rng.uniform(0, 700, d)
    dets[:, 2:] = dets[:, :2] + rng.uniform(40, 400, (d, 2))
    # a few at the projected boxes themselves
    b2d, vis = tbc.project_boxes_to_cameras(t(boxes), t(l2i))
    cam_of = vis.numpy().argmax(axis=0)
    for k in range(8):
        dets[k] = b2d[cam_of[k], k].numpy()
    cams = np.concatenate([cam_of[:8], rng.randint(0, 6, d - 8)])
    mask = np.arange(d) < 40
    return (boxes, l2i, dets, rng.randint(0, 12, d).astype(np.int32),
            rng.uniform(0.2, 1.0, d).astype(np.float32),
            cams.astype(np.int32), mask)


@pytest.mark.parametrize("case", ["cached", "other_camera", "ring"])
def test_glip_relabel_matches_reference(case):
    args = glip_inputs(case)
    got = tbc.GLIPBoxClassification(10).relabel(*[t(a) for a in args])
    want = jbc.GLIPBoxClassification(10).relabel(
        *[jnp.asarray(a) for a in args])
    hold_relabel(got, want)
    if case == "cached":
        assert got[0].tolist() == [3, 7]
        assert abs(float(got[1][0]) - 0.8) < 0.1
    elif case == "other_camera":
        assert got[0].tolist() == [4]
    else:
        assert len(set(got[0].tolist())) > 2


# ------------------------------------------------------------ stand-ins

class TorchCLIPStandIn:
    """A seeded stand-in for CLIP's image tower: the crop's mean over 2x2
    quadrants of each channel, through a seeded (12, E) projection."""

    def __init__(self, weight):
        self.weight = torch.from_numpy(weight)

    def get_image_features(self, pixel_values):
        n = pixel_values.shape[0]
        q = pixel_values.reshape(n, 3, 2, 112, 2, 112).mean(dim=(3, 5))
        return q.reshape(n, 12) @ self.weight.to(q)


class JaxCLIPStandIn:
    def __init__(self, weight):
        self.weight = jnp.asarray(weight)

    def get_image_features(self, pixel_values):
        p = jnp.asarray(pixel_values)
        q = p.reshape(p.shape[0], 3, 2, 112, 2, 112).mean(axis=(3, 5))
        return q.reshape(p.shape[0], 12) @ self.weight


def dense_rows_cols(h, w, g=7):
    return ((np.arange(g) + 0.5) * h / g).astype(int), \
        ((np.arange(g) + 0.5) * w / g).astype(int)


def torch_dense(weight):
    """MaskCLIP's dense stand-in: the pixels at a 7x7 grid through a
    seeded (3, E) projection (a gather, so both packages see the same
    features up to the projection's sum)."""
    wt = torch.from_numpy(weight)

    def encode(images):
        r, c = dense_rows_cols(*images.shape[1:3])
        g = images[:, torch.from_numpy(r)][:, :, torch.from_numpy(c)]
        return g @ wt.to(g)
    return encode


def jax_dense(weight):
    wj = jnp.asarray(weight)

    def encode(images):
        r, c = dense_rows_cols(*images.shape[1:3])
        return jnp.asarray(images)[:, r][:, :, c] @ wj
    return encode


def stand_in_weights(seed, e=8, c=3):
    rng = np.random.RandomState(seed)
    text = rng.normal(size=(c, e)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return (rng.normal(size=(12, e)).astype(np.float32),
            rng.normal(size=(3, e)).astype(np.float32), text)


def painted_images(l2i, boxes, ncam, seed):
    """Seeded noise with each box's projection painted red or blue."""
    rng = np.random.RandomState(seed)
    img = (rng.uniform(0, 0.3, (ncam, H, W, 3))).astype(np.float32)
    b2d, vis = tbc.project_boxes_to_cameras(t(boxes), t(l2i))
    for k in range(len(boxes)):
        for c in np.flatnonzero(vis[:, k].numpy()):
            x0, y0, x1, y1 = b2d[c, k].numpy().astype(int)
            img[c, y0:y1, x0:x1, 0 if k % 2 == 0 else 2] = 1.0
    return img


# ------------------------------------------------------------------- CROP

def test_crop_indices_equal_reference():
    """The crops' pixels, bit for bit, from the same 2D boxes (f32 grid
    y1 + (i + 0.5) * s / 224, truncated), edges and tiny boxes included."""
    l2i, _, _ = ring_rig()
    want_b2d, vis = jbc.project_boxes_to_cameras(
        jnp.asarray(scene_boxes(2, 30)), jnp.asarray(l2i))
    b2d = np.asarray(want_b2d).copy()
    b2d[0, :4] = [[0, 0, 1600, 900], [1599.5, 899.5, 1600, 900],
                  [10.3, 20.7, 11.1, 21.9], [333.33, 444.44, 777.77, 888.8]]
    rng = np.random.RandomState(0)
    images = rng.uniform(size=(6, H, W, 3)).astype(np.float32)
    clip_t = tbc.CLIPBoxClassification(["a", "b"])
    clip_j = jbc.CLIPBoxClassification(["a", "b"])
    got = clip_t.crop_boxes(t(images), t(b2d))
    want = clip_j.crop_boxes(jnp.asarray(images), jnp.asarray(b2d),
                             jnp.asarray(vis))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("encoder", ["mean_rgb", "seeded"])
def test_clip_relabel_matches_reference(encoder):
    ncam = 2 if encoder == "seeded" else 1
    if encoder == "mean_rgb":
        cam, _, _ = make_camera()
        l2i = cam[None].astype(np.float32)
        boxes = BOXES3D
    else:
        l2i = ring_rig()[0][:ncam]
        boxes = scene_boxes(3, 10)
    images = painted_images(l2i, boxes, ncam, seed=1)
    names = ["red_thing", "blue_thing", "other"]
    clip_t = tbc.CLIPBoxClassification(names)
    clip_j = jbc.CLIPBoxClassification(names)
    if encoder == "mean_rgb":
        # the reference's stub: the crop's mean normalised RGB, text
        # features along the colours
        mean, std = np.array(tbc.CLIP_MEAN), np.array(tbc.CLIP_STD)
        text = np.stack([(np.eye(3)[k] - mean) / std for k in (0, 2, 1)])
        text = (text / np.linalg.norm(text, axis=1, keepdims=True)).astype(
            np.float32)
        clip_t._model = type("Stub", (), {"get_image_features": staticmethod(
            lambda pixel_values: pixel_values.mean(dim=(2, 3)))})()
        clip_j._model = type("Stub", (), {"get_image_features": staticmethod(
            lambda pixel_values: jnp.asarray(pixel_values).mean(
                axis=(2, 3)))})()
    else:
        w_img, _, text = stand_in_weights(4)
        clip_t._model = TorchCLIPStandIn(w_img)
        clip_j._model = JaxCLIPStandIn(w_img)
    clip_t._text_features = t(text)
    clip_j._text_features = jnp.asarray(text)
    got = clip_t.relabel(t(boxes), t(l2i), t(images))
    want = clip_j.relabel(jnp.asarray(boxes), jnp.asarray(l2i),
                          jnp.asarray(images))
    hold_relabel(got, want)
    if encoder == "mean_rgb":
        assert got[0].tolist() == [1, 2] and (got[1] > 0.5).all()


# --------------------------------------------------------------- MaskCLIP

def test_maskclip_pixel_probs_match_reference():
    """Normalise, logits at the logit scale, softmax and the bilinear
    resize of a 7x7 grid to 900x1600, at the image's edges too."""
    _, w_dense, text = stand_in_weights(6, c=4)
    rng = np.random.RandomState(6)
    images = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    mt = MaskCLIP(["a", "b", "c", "d"])
    mt._encode_dense, mt._text_features = torch_dense(w_dense), t(text)
    mj = jmc.MaskCLIP(["a", "b", "c", "d"])
    mj._encode_dense, mj._text_features = jax_dense(w_dense), \
        jnp.asarray(text)
    got = mt.pixel_probs(t(images)).numpy()
    want = np.asarray(mj.pixel_probs(jnp.asarray(images)))
    assert got.shape == want.shape == (1, H, W, 4)
    for rows, cols in ((slice(None, 70), slice(None)),
                       (slice(-70, None), slice(None)),
                       (slice(None), slice(None, 120)),
                       (slice(None), slice(-120, None)),
                       (slice(None), slice(None))):
        np.testing.assert_allclose(got[0, rows, cols], want[0, rows, cols],
                                   atol=TOL, rtol=0)


class JaxPaintStub:
    """The reference's _StubMaskCLIP: class 1 where red is lit, class 2
    where blue, the rest class 3."""

    def pixel_probs(self, images):
        r, b = images[..., 0], images[..., 2]
        return jnp.stack([r, b, 1.0 - jnp.clip(r + b, 0, 1)], -1)


class TorchPaintStub:
    def pixel_probs(self, images):
        r, b = images[..., 0], images[..., 2]
        return torch.stack([r, b, 1.0 - (r + b).clamp(0, 1)], -1)


@pytest.mark.parametrize("encoder", ["paint", "seeded"])
def test_maskclip_relabel_matches_reference(encoder):
    names = ["red_thing", "blue_thing", "bg"]
    if encoder == "paint":
        cam, _, _ = make_camera()
        l2i, boxes, ncam = cam[None].astype(np.float32), BOXES3D, 1
        mt, mj = TorchPaintStub(), JaxPaintStub()
    else:
        ncam = 2
        l2i, boxes = ring_rig()[0][:ncam], scene_boxes(7, 4)
        _, w_dense, text = stand_in_weights(8)
        mt, mj = MaskCLIP(names), jmc.MaskCLIP(names)
        mt._encode_dense, mt._text_features = torch_dense(w_dense), t(text)
        mj._encode_dense, mj._text_features = jax_dense(w_dense), \
            jnp.asarray(text)
    images = painted_images(l2i, boxes, ncam, seed=2)
    got = tbc.CLIPBoxClassificationMaskCLIP(names, maskclip=mt).relabel(
        t(boxes), t(l2i), t(images))
    want = jbc.CLIPBoxClassificationMaskCLIP(names, maskclip=mj).relabel(
        jnp.asarray(boxes), jnp.asarray(l2i), jnp.asarray(images))
    hold_relabel(got, want)
    if encoder == "paint":
        assert got[0].tolist() == [1, 2] and (got[1] > 0.5).all()


def test_encoders_raise_without_transformers(monkeypatch):
    """Without the `transformers` package (as on the card's machine) the
    encoders raise, naming the package and the weights."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    for load in (tbc.CLIPBoxClassification(["a"])._load,
                 MaskCLIP(["a"])._load):
        with pytest.raises(RuntimeError, match="transformers.*weights"):
            load()


# --------------------------------------------------------- build_relabeler

def test_build_relabeler_dispatch():
    assert tst.build_relabeler({"CLIP_UNK_RELABEL": False}, ["a"],
                               device="cpu") is None
    kinds = {"GLIP": tbc.GLIPBoxClassification,
             "CROP": tbc.CLIPBoxClassification,
             "MASKCLIP": tbc.CLIPBoxClassificationMaskCLIP}
    for clip_type, cls in kinds.items():
        r = tst.build_relabeler({"CLIP_UNK_RELABEL": True,
                                 "CLIP_TYPE": clip_type}, ["a", "b"],
                                device="cpu")
        assert isinstance(r.vlm, cls)
        # no detector / no images: the labels pass through unchanged
        lab, sc = r(np.zeros((2, 7), np.float32), {}, 0,
                    np.asarray([1, 2]), np.asarray([0.5, 0.6]))
        assert list(lab) == [1, 2] and list(sc) == [0.5, 0.6]


class Rigged:
    """The inference loader's batches with the keys the relabelers read:
    a 2-camera rig's lidar2image and per-frame camera image names."""

    def __init__(self, loader, l2i):
        self.loader, self.l2i = loader, l2i

    def __iter__(self):
        for batch in self.loader:
            n = len(batch["frame_id"])
            batch["lidar2image"] = np.repeat(self.l2i[None], n, axis=0)
            batch["camera_paths"] = [
                [f"samples/{c}/frame{f}__{c}.jpg" for c in CAMERA_NAMES[:2]]
                for f in batch["frame_id"]]
            yield batch


def frame_images(batch, i):
    return np.random.RandomState(int(batch["frame_id"][i])).uniform(
        size=(2, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("clip_type", ["GLIP", "CROP", "MASKCLIP"])
def test_build_relabeler_through_extraction(tmp_path, monkeypatch,
                                            clip_type):
    """build_relabeler end to end through the port's extract_pseudo_labels
    on a narrow model: every frame stored with the relabeled labels and
    scores, equal to the JAX package's build_relabeler on the same boxes
    and batch (same stand-ins), and different from the plain
    extraction's."""
    names = ["car", "pedestrian", "traffic_cone"]
    l2i = ring_rig()[0][:2]
    det, ds = narrow_detector()
    _, loader, _ = build_dataloader(cfg_mod.EDict(DATA), ds.class_names,
                                    batch_size=2, training=False)
    rng = np.random.RandomState(9)
    paths = []
    for c, cam in enumerate(CAMERA_NAMES[:2]):
        anns = [{"image_id": f + 1, "bbox": [float(x) for x in np.r_[
            rng.uniform(0, 1200, 2), rng.uniform(100, 500, 2)]],
            "category_id": int(rng.randint(1, 4)),
            "score": float(rng.uniform(0.3, 1))}
            for f in range(2) for _ in range(10)]
        p = tmp_path / f"{cam}.json"
        p.write_text(json.dumps({
            "images": [{"id": f + 1, "file_name":
                        f"samples/{cam}/frame{f}__{cam}.jpg"}
                       for f in range(2)],
            "categories": [{"id": k + 1, "name": n}
                           for k, n in enumerate(names)],
            "annotations": anns}))
        paths.append(p)
    detector2d = PreprocessedDetector(paths, names)
    w_img, w_dense, text = stand_in_weights(10)
    opt = {"CLIP_UNK_RELABEL": True, "CLIP_TYPE": clip_type}
    relabel = tst.build_relabeler(opt, names, detector2d=detector2d,
                                  image_provider=frame_images, device="cpu")
    if clip_type == "CROP":
        relabel.vlm._model = TorchCLIPStandIn(w_img)
        relabel.vlm._text_features = t(text)
    elif clip_type == "MASKCLIP":
        relabel.vlm.maskclip._encode_dense = torch_dense(w_dense)
        relabel.vlm.maskclip._text_features = t(text)

    # the reference's relabeler with the same stand-ins
    class JaxClip(jbc.CLIPBoxClassification):
        def __init__(self, class_names):
            super().__init__(class_names)
            self._model = JaxCLIPStandIn(w_img)
            self._text_features = jnp.asarray(text)

    class JaxMaskClip(jbc.CLIPBoxClassificationMaskCLIP):
        def __init__(self, class_names):
            m = jmc.MaskCLIP(class_names)
            m._encode_dense = jax_dense(w_dense)
            m._text_features = jnp.asarray(text)
            super().__init__(class_names, maskclip=m)

    monkeypatch.setattr(jbc, "CLIPBoxClassification", JaxClip)
    monkeypatch.setattr(jbc, "CLIPBoxClassificationMaskCLIP", JaxMaskClip)
    ref = jst.build_relabeler(opt, names, detector2d=detector2d,
                              image_provider=frame_images)

    seen = []

    def spy(boxes, batch, i, labels, scores):
        out = relabel(boxes, batch, i, labels, scores)
        seen.append((labels, ref(boxes, batch, i, labels, scores), out))
        return out

    proc = PseudoProcessor(["car"], self_training_folder=tmp_path / "st",
                           all_class_names=list(ds.class_names))
    n = tst.extract_pseudo_labels(det, Rigged(loader, l2i), proc, epoch=1,
                                  relabeler=spy)
    assert n == 2 and len(seen) == 2
    changed = 0
    for i, (plain, want, got) in enumerate(seen):
        hold_relabel(got, want)
        _, s, lab = proc.store.load(i)
        np.testing.assert_array_equal(lab, got[0])
        np.testing.assert_array_equal(s, got[1])
        changed += int((lab != plain).sum())
    assert changed > 0
