"""PyTorch port of the Greedy Box Seeker against the JAX package, CPU, small
sizes: the geometry, NMS and camera modules it runs on, then
FrustumProposerOG.propose against the JAX propose (depth-sorted path and
per-detection point-mask path, every oracle option), against the numpy
loop oracle of tests/test_seeker_parity.py at the full default config, and
on the closed-form hand fixture of tests/test_seeker_fixture.py.

Tolerances: the two packages round the same f32 operations in another
order (XLA's dot and reductions against sums written out), so coordinates
agree to a few ulps of their magnitude; 1e-4 absolute on boxes and oracle
scores, 1e-5 on the small modules, and the numpy oracle's own tolerances
(coordinates 2e-3, dimensions 1e-5, oracle 1e-3). Masks, indices, counts
and labels are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.openvocab import camera as TC
from findnpropagate_torch.openvocab import frustum_proposer as fp
from findnpropagate_torch.openvocab.frustum_proposer import (
    FrustumProposerOG,
    linspace01,
)
from findnpropagate_torch.ops import nms as TN
from findnpropagate_torch.ops import rotated_iou as TR
from findnpropagate_torch.utils import geometry as TG
from findnpropagate_tpu.openvocab import camera as JC
from findnpropagate_tpu.openvocab.frustum_proposer import (
    FrustumProposerOG as JaxOG,
)
from findnpropagate_tpu.ops import nms as JN
from findnpropagate_tpu.ops import rotated_iou as JR
from findnpropagate_tpu.utils import geometry as JG
from test_frustum_proposer import CLASS_NAMES, make_camera
from test_seeker_fixture import expected_final_x
from test_seeker_fixture import make_rig as fixture_rig
from test_seeker_parity import corners_np, seeker_oracle

# a config small enough for the JAX CPU compile: 2 magnitudes x 2 sizes x
# 2 headings; headings 0 and 1.5 (0 and pi would describe the same box
# twice, a tie only rounding decides)
SMALL = dict(num_mags=2, num_sizes=2, num_rotations=2, ry_max=1.5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a):
    return torch.from_numpy(np.asarray(a))


def random_boxes(rng, n, spread=20.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :3] = rng.uniform(-spread, spread, (n, 3))
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def ring_rig(ncam=6):
    """bench.py's 6-camera yaw ring (K = 1266.4 / 800 / 450)."""
    k = np.array([[1266.4, 0, 800.0], [0, 1266.4, 450.0], [0, 0, 1.0]])
    r_c2l = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    l2i, c2l, intr = [], [], []
    for ci in range(ncam):
        yaw = ci * np.pi / 3
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        c = np.eye(4)
        c[:3, :3] = rot @ r_c2l
        l2c = np.linalg.inv(c)
        m = np.eye(4)
        m[:3, :3] = k @ l2c[:3, :3]
        m[:3, 3] = k @ l2c[:3, 3]
        i4 = np.eye(4)
        i4[:3, :3] = k
        l2i.append(m)
        c2l.append(c)
        intr.append(i4)
    return tuple(np.stack(x).astype(np.float32) for x in (l2i, c2l, intr))


def aug_matrix(yaw=0.2, scale=1.05, t=(0.5, -0.3, 0.1)):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:3, :3] = scale * np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    m[:3, 3] = t
    return m


def cluster(rng, box, n):
    local = rng.uniform(-0.5, 0.5, (n, 3)) * box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    return np.stack([local[:, 0] * c - local[:, 1] * s,
                     local[:, 0] * s + local[:, 1] * c, local[:, 2]],
                    -1) + box[:3]


def project_det(box, l2i):
    hom = corners_np(box[None])[0] @ l2i[:3, :3].T + l2i[:3, 3]
    u, v = hom[:, 0] / hom[:, 2], hom[:, 1] / hom[:, 2]
    return np.array([u.min(), v.min(), u.max(), v.max()], np.float32)


def rig_scene(seed=0):
    """make_camera's rig: road clutter, three objects, and eight detection
    slots: the three objects, a shifted duplicate of the first (2D NMS), a
    box with no points behind it, one under score_thr, one of an equal
    score to the first (a tie) and a padded slot."""
    l2i, c2l, intr = make_camera()
    rng = np.random.RandomState(seed)
    objs = [(np.array([14.0, 2.0, -0.8, 4.63, 1.97, 1.74, 0.3]), 1),
            (np.array([9.0, -2.5, -0.6, 0.73, 0.67, 1.77, 0.0]), 9),
            (np.array([24.0, -4.0, -0.5, 4.5, 1.9, 1.7, 1.1]), 1)]
    pts = [rng.uniform(-30, 30, (600, 3)) * np.array([1, 0.3, 0.05])]
    pts += [cluster(rng, b, 300) for b, _ in objs]
    points = np.concatenate(pts).astype(np.float32)
    db = np.zeros((8, 4), np.float32)
    for i, (b, _) in enumerate(objs):
        db[i] = project_det(b, l2i)
    db[3] = db[0] + 3.0
    db[4] = [10.0, 10.0, 40.0, 40.0]
    db[5] = db[1] + 1.0
    db[6] = db[2] - 2.0
    return dict(
        points=points, points_mask=np.ones(len(points), bool),
        det_boxes=db,
        det_labels=np.array([1, 9, 1, 1, 2, 9, 7, 1], np.int32),
        det_scores=np.array([.9, .8, .7, .6, .5, .05, .9, .0], np.float32),
        det_cams=np.zeros(8, np.int32),
        det_mask=np.array([1, 1, 1, 1, 1, 1, 1, 0], bool),
        lidar2image=l2i[None].astype(np.float32),
        camera2lidar=c2l[None].astype(np.float32),
        intrinsics=intr[None].astype(np.float32))


def ring_scene(seed=0, n_points=6000, n_dets=12):
    """bench.py's inputs at a small size: points uniform in +-30 m (z in
    [-3, 1]), random 2D boxes over the six cameras."""
    rng = np.random.RandomState(seed)
    l2i, c2l, intr = ring_rig()
    pts = rng.uniform(-30, 30, (n_points, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 1, n_points)
    db = np.zeros((n_dets, 4), np.float32)
    db[:, 0] = rng.uniform(0, 1400, n_dets)
    db[:, 1] = rng.uniform(0, 700, n_dets)
    db[:, 2] = db[:, 0] + rng.uniform(40, 300, n_dets)
    db[:, 3] = db[:, 1] + rng.uniform(40, 300, n_dets)
    return dict(
        points=pts, points_mask=rng.rand(n_points) > 0.05, det_boxes=db,
        det_labels=rng.randint(1, 11, n_dets).astype(np.int32),
        det_scores=rng.uniform(0.2, 1.0, n_dets).astype(np.float32),
        det_cams=rng.randint(0, 6, n_dets).astype(np.int32),
        det_mask=np.arange(n_dets) < n_dets - 1,
        lidar2image=l2i, camera2lidar=c2l, intrinsics=intr)


ARGS = ("points", "points_mask", "det_boxes", "det_labels", "det_scores",
        "det_cams", "det_mask", "lidar2image", "camera2lidar", "intrinsics")


def run_both(kw, scene, **extra):
    """The JAX and the port's propose on the same scene -> numpy outputs."""
    jx = JaxOG(class_names=CLASS_NAMES, **kw)
    pt = FrustumProposerOG(class_names=CLASS_NAMES, **kw)
    args = [scene[a] for a in ARGS]
    ref = jx.propose(*[jnp.asarray(a) for a in args],
                     **{k: jnp.asarray(v) for k, v in extra.items()})
    got = pt.propose(*args, **extra, device="cpu")
    return (jax.tree.map(np.asarray, ref),
            type(got)(*(np.asarray(t) for t in got)))


def assert_same_output(got, ref, atol=1e-4):
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.scores, ref.scores)
    v = ref.valid
    np.testing.assert_allclose(got.boxes[v], ref.boxes[v], atol=atol)
    np.testing.assert_allclose(got.oracle[v], ref.oracle[v], atol=atol)


# ------------------------------------------------------------- modules

def test_linspace01_matches_jnp():
    for m in range(1, 40):
        np.testing.assert_array_equal(
            linspace01(m), np.asarray(jnp.linspace(0.0, 1.0, m)))


@pytest.mark.parametrize("aug", [False, True])
def test_project_to_camera(aug):
    rng = np.random.RandomState(0)
    l2i, _, _ = ring_rig()
    pts = rng.uniform(-40, 40, (2000, 3)).astype(np.float32)
    lam = aug_matrix() if aug else None
    ref_c, ref_m = JC.project_to_camera(
        jnp.asarray(pts), jnp.asarray(l2i),
        None if lam is None else jnp.asarray(lam), (900, 1600))
    got_c, got_m = TC.project_to_camera(
        tt(pts), tt(l2i), None if lam is None else tt(lam), (900, 1600))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    m = np.asarray(ref_m)
    np.testing.assert_allclose(got_c.numpy()[m], np.asarray(ref_c)[m],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("aug", [False, True])
def test_get_geometry_at_image_coords(aug):
    rng = np.random.RandomState(1)
    _, c2l, intr = ring_rig()
    cam = rng.randint(0, 6, 50)
    uvd = np.stack([rng.uniform(0, 1600, 50), rng.uniform(0, 900, 50),
                    rng.uniform(2, 50, 50)], -1).astype(np.float32)
    lam = aug_matrix()
    extra = dict(extra_rots=lam[:3, :3], extra_trans=lam[:3, 3]) \
        if aug else {}
    ref = JC.get_geometry_at_image_coords(
        jnp.asarray(uvd), jnp.asarray(c2l[cam, :3, :3]),
        jnp.asarray(c2l[cam, :3, 3]), jnp.asarray(intr[cam, :3, :3]),
        **{k: jnp.asarray(v) for k, v in extra.items()})
    got = TC.get_geometry_at_image_coords(
        tt(uvd), tt(c2l[cam, :3, :3]), tt(c2l[cam, :3, 3]),
        tt(intr[cam, :3, :3]), **{k: tt(v) for k, v in extra.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(
        TC.get_cam_frustum(tt(uvd[:2].reshape(6))).numpy(),
        np.asarray(JC.get_cam_frustum(jnp.asarray(uvd[:2].reshape(6)))),
        atol=1e-5)


def test_masked_quantile():
    rng = np.random.RandomState(2)
    v = rng.randn(7, 100).astype(np.float32)
    m = rng.rand(7, 100) > 0.4
    m[3] = False                                    # empty -> 0
    m[4] = np.arange(100) == 17                     # one point
    for q in (0.0, 0.1, 0.336, 0.356, 0.46, 0.5, 1.0):
        ref = np.stack([np.asarray(JC.masked_quantile(
            jnp.asarray(v[i]), jnp.asarray(m[i]), q)) for i in range(7)])
        got = TC.masked_quantile(tt(v), tt(m), q).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_boxes_2d_iou():
    rng = np.random.RandomState(3)
    a = np.sort(rng.uniform(0, 100, (9, 2, 2)), axis=1).transpose(
        0, 2, 1).reshape(9, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    b = a[::-1].copy() + 3.0
    np.testing.assert_allclose(
        TC.boxes_2d_iou(tt(a), tt(b)).numpy(),
        np.asarray(JC.boxes_2d_iou(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)


def test_nms_2d_ties_and_cameras():
    """Equal scores (the lower index first, as jnp.argsort), invalid
    entries, two classes; the port's batched call over cameras equals one
    JAX call per camera."""
    rng = np.random.RandomState(4)
    n = 40
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(10, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.choice([0.3, 0.5, 0.5, 0.9], n).astype(np.float32)
    labels = rng.randint(1, 3, n).astype(np.int32)
    cams = rng.randint(0, 3, n)
    valid = (cams[None] == np.arange(3)[:, None]) & (rng.rand(n) > 0.1)
    got = TC.nms_2d(tt(boxes), tt(scores), tt(labels), 0.3,
                    valid=tt(valid)).numpy()
    for c in range(3):
        ref = np.asarray(JC.nms_2d(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(labels), 0.3,
                                   valid=jnp.asarray(valid[c])))
        np.testing.assert_array_equal(got[c], ref)
    ref = np.asarray(JC.nms_2d(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(labels), 0.3))
    np.testing.assert_array_equal(
        TC.nms_2d(tt(boxes), tt(scores), tt(labels), 0.3).numpy(), ref)


def test_corners_and_points_in_boxes():
    rng = np.random.RandomState(5)
    boxes = random_boxes(rng, 12, 5.0)
    pts = rng.uniform(-8, 8, (3000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TG.boxes_to_corners_3d(tt(boxes)).numpy(),
        np.asarray(JG.boxes_to_corners_3d(jnp.asarray(boxes))), atol=1e-5)
    np.testing.assert_allclose(
        TG.boxes_to_corners_bev(tt(boxes)).numpy(),
        np.asarray(JG.boxes_to_corners_bev(jnp.asarray(boxes))), atol=1e-5)
    ref = np.asarray(JG.points_in_boxes_mask(jnp.asarray(pts),
                                             jnp.asarray(boxes)))
    assert ref.sum() > 100
    np.testing.assert_array_equal(
        TG.points_in_boxes_mask(tt(pts), tt(boxes)).numpy(), ref)
    bm = np.arange(12) % 3 != 0
    np.testing.assert_array_equal(
        TG.points_in_boxes_index(tt(pts), tt(boxes), tt(bm)).numpy(),
        np.asarray(JG.points_in_boxes_index(jnp.asarray(pts),
                                            jnp.asarray(boxes),
                                            jnp.asarray(bm))))


def test_boxes_iou_bev():
    rng = np.random.RandomState(6)
    a = random_boxes(rng, 10, 3.0)
    b = np.concatenate([a[:4], random_boxes(rng, 6, 3.0)])
    np.testing.assert_allclose(
        TR.boxes_iou_bev(tt(a), tt(b)).numpy(),
        np.asarray(JR.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)
    np.testing.assert_allclose(
        TR._height_overlap(tt(a), tt(b)).numpy(),
        np.asarray(JR._height_overlap(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)


def nms_case(seed, n=60):
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, n, 6.0)
    scores = rng.choice([0.1, 0.4, 0.4, 0.7, 0.7, 0.95], n).astype(
        np.float32)
    valid = rng.rand(n) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("fn", ["nms_bev", "nms_normal_bev"])
@pytest.mark.parametrize("post", [1, 2, 20, 100])
def test_nms_ties_against_jax(fn, post):
    """Indices and counts equal, with tied scores and a valid mask."""
    boxes, scores, valid = nms_case(7)
    for vm in (None, valid):
        ref_i, ref_n = getattr(JN, fn)(
            jnp.asarray(boxes), jnp.asarray(scores), 0.2, pre_maxsize=50,
            post_maxsize=post,
            valid_mask=None if vm is None else jnp.asarray(vm))
        got_i, got_n = getattr(TN, fn)(
            tt(boxes), tt(scores), 0.2, pre_maxsize=50, post_maxsize=post,
            valid_mask=None if vm is None else tt(vm))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        assert int(got_n) == int(ref_n)


def test_nms_top1_shortcut_equals_greedy_path():
    """post_maxsize=1 skips the greedy loop: its index equals the first
    index of the general path (post_maxsize=2) on every row of a batch
    with ties, all-invalid rows and duplicated boxes."""
    rng = np.random.RandomState(8)
    b, n = 64, 24
    boxes = np.stack([random_boxes(rng, n, 2.0) for _ in range(b)])
    boxes[:, 1::2] = boxes[:, ::2]                 # duplicates overlap
    scores = rng.choice([-1e9, 0.2, 0.5, 0.5, 0.8], (b, n)).astype(
        np.float32)
    scores[:, :3] = 0.8                            # a tie at the top
    valid = rng.rand(b, n) > 0.3
    valid[5] = False
    for fn in (TN.nms_bev, TN.nms_normal_bev):
        one_i, one_n = fn(tt(boxes), tt(scores), 0.1, pre_maxsize=n,
                          post_maxsize=1, valid_mask=tt(valid))
        two_i, _ = fn(tt(boxes), tt(scores), 0.1, pre_maxsize=n,
                      post_maxsize=2, valid_mask=tt(valid))
        np.testing.assert_array_equal(one_i[:, 0].numpy(),
                                      two_i[:, 0].numpy())
        np.testing.assert_array_equal(one_n.numpy(),
                                      (two_i[:, 0] >= 0).int().numpy())
        assert (one_i[:, 0] == -1).any() and (one_i[:, 0] >= 0).any()


# ------------------------------------------------------------- propose

@pytest.fixture
def pinned_eigh(monkeypatch):
    """The reference's alignment term depends on the sign LAPACK gives an
    eigenvector, which LAPACK leaves open (JAX's and torch's CPU builds
    differ on 5-17 % of random 3x3 matrices). The port pins it: the
    largest-magnitude component positive. The reference is held to the
    same convention here, through its own jnp.linalg.eigh."""
    orig = jnp.linalg.eigh

    def eigh(a, *args, **kw):
        w, v = orig(a, *args, **kw)
        big = jnp.take_along_axis(
            v, jnp.argmax(jnp.abs(v), axis=-2, keepdims=True), axis=-2)
        return w, jnp.where(big < 0, -v, v)

    monkeypatch.setattr(jnp.linalg, "eigh", eigh)


@pytest.mark.parametrize("kw", [
    {},
    {"nms_3d": 0.5, "aln_w": 0.1, "occl_w": 0.2, "ego_w": 0.05},
    {"mult": True, "ego_w": 0.05},
    {"occl_mult": True, "topk": 2},
], ids=["default", "nms3d_aln_occl_ego", "mult", "occl_mult_top2"])
def test_propose_matches_jax_rig(kw, pinned_eigh):
    ref, got = run_both({**SMALL, **kw}, rig_scene())
    assert ref.valid.sum() >= 3
    assert_same_output(got, ref)


def test_propose_det_point_mask_matches_jax(pinned_eigh):
    """The per-detection point-mask path (the SEG variant's input), with
    an aggressive random mask, nms_3d and the optional terms on."""
    scene = rig_scene(seed=1)
    rng = np.random.RandomState(9)
    dpm = rng.rand(8, len(scene["points"])) > 0.3
    dpm[2] = False                                 # no point left
    ref, got = run_both({**SMALL, "nms_3d": 0.5, "aln_w": 0.1,
                         "occl_w": 0.2, "ego_w": 0.05}, scene,
                        det_point_mask=dpm)
    assert ref.valid.sum() >= 2 and not ref.valid[2]
    assert_same_output(got, ref)


def test_propose_ring_with_aug_matches_jax():
    """Six cameras (per-camera 2D NMS in one batched call) and a lidar
    augmentation matrix, at bench.py's input recipe, small."""
    ref, got = run_both(SMALL, ring_scene(), lidar_aug_matrix=aug_matrix())
    assert ref.valid.sum() >= 4
    assert_same_output(got, ref)


def test_propose_batch_matches_jax():
    """propose_batch: a missing augmentation is the identity per sample
    (applied and inverted, unlike lidar_aug_matrix=None)."""
    scenes = [ring_scene(seed=s, n_points=3000, n_dets=6) for s in (3, 4)]
    batch = {k: np.stack([s[k] for s in scenes]) for k in ARGS}
    batch["camera_intrinsics"] = batch.pop("intrinsics")
    ref = JaxOG(class_names=CLASS_NAMES, **SMALL).propose_batch(
        {k: jnp.asarray(v) for k, v in batch.items()})
    pt = FrustumProposerOG(class_names=CLASS_NAMES, **SMALL)
    got = pt.propose_batch(batch, device="cpu")
    ref = jax.tree.map(np.asarray, ref)
    for i in range(2):
        assert_same_output(type(got)(*(np.asarray(t[i]) for t in got)),
                           type(ref)(*(t[i] for t in ref)))
    one = pt.propose(*[scenes[0][a] for a in ARGS], device="cpu",
                     lidar_aug_matrix=np.eye(4, dtype=np.float32))
    for a, b in zip(one, got):
        np.testing.assert_array_equal(a.numpy(), b[0].numpy())


def test_det_chunk_invariance(monkeypatch):
    """The point-in-proposal test runs det_chunk detections at a time (no
    more: the step budget set to 1 pair); the result does not depend on
    it, bit for bit, with the occlusion and alignment terms on too."""
    monkeypatch.setattr(fp, "PAIRS_PER_STEP", 1)
    scene = ring_scene(seed=5)
    outs = [FrustumProposerOG(class_names=CLASS_NAMES, det_chunk=c,
                              occl_w=0.2, aln_w=0.1).propose(
        *[scene[a] for a in ARGS], device="cpu") for c in (1, 3, 8, 64)]
    assert outs[0].valid.sum() >= 4
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def same_box(got, want, atol):
    """Centre and size within atol, heading within atol modulo pi: headings
    0 and pi of the default grid are the same box, and only rounding picks
    one of them."""
    np.testing.assert_allclose(got[:6], want[:6], atol=atol)
    dy = (got[6] - want[6]) % np.pi
    assert min(dy, np.pi - dy) < atol, (got[6], want[6])


def test_propose_full_config_matches_loop_oracle():
    """The default config (6 x 4 x 10 proposals) against the independent
    numpy oracle of tests/test_seeker_parity.py, on its scene, with its
    tolerances: coordinates 2e-3, dimensions 1e-5, oracle 1e-3."""
    l2i, c2l, intr = make_camera()
    rng = np.random.RandomState(7)
    cfg = FrustumProposerOG(class_names=CLASS_NAMES)
    objs = [(np.array([14.0, 2.0, -0.8, 4.63, 1.97, 1.74, 0.3]), 1),
            (np.array([9.0, -2.5, -0.6, 0.73, 0.67, 1.77, 0.0]), 9)]
    pts = [rng.uniform(-30, 30, (600, 3)) * np.array([1, 0.3, 0.05])]
    pts += [cluster(rng, b, 300) for b, _ in objs]
    points = np.concatenate(pts).astype(np.float64)
    dets = [(project_det(b, l2i).astype(np.float64), lb) for b, lb in objs]
    want = [seeker_oracle(cfg, points, db, lb, l2i, c2l, intr)
            for db, lb in dets]
    d = len(dets)
    out = cfg.propose(
        points.astype(np.float32), np.ones(len(points), bool),
        np.stack([db for db, _ in dets]).astype(np.float32),
        np.array([lb for _, lb in dets], np.int32),
        np.full(d, 0.9, np.float32), np.zeros(d, np.int32),
        np.ones(d, bool), l2i[None].astype(np.float32),
        c2l[None].astype(np.float32), intr[None].astype(np.float32),
        device="cpu")
    for i, w in enumerate(want):
        assert w is not None and bool(out.valid[i])
        wb, ws = w
        got = out.boxes[i].numpy()
        same_box(got, wb, 2e-3)
        np.testing.assert_allclose(got[3:6], wb[3:6], atol=1e-5)
        assert abs(float(out.oracle[i]) - ws) < 1e-3


def fixture_seeker():
    return FrustumProposerOG(
        class_names=("car",), anchors=((4.0, 2.0, 1.5),),
        num_mags=2, num_sizes=1, num_rotations=1,
        size_min=1.0, size_max=1.0, ry_min=0.0, ry_max=0.0,
        image_size=(300, 400), det_chunk=1, topk=1,
        point_cloud_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 5.0))


@pytest.mark.parametrize("start,step,det,fmin,fmax", [
    (10.0, 0.1, (188.0, 140.0, 212.0, 160.0), 10.672, 10.712),
    (20.0, 0.2, (195.0, 146.0, 205.0, 154.0), 21.344, 21.424),
])
def test_hand_fixture(start, step, det, fmin, fmax):
    """tests/test_seeker_fixture.py's closed-form fixture: 21 points on
    the optical axis; the box lands on one of the two hand-computed
    magnitude placements."""
    pts = np.zeros((64, 3), np.float32)
    pts[:21, 0] = start + step * np.arange(21)
    pmask = np.arange(64) < 21
    l2i, c2l, intr = (np.asarray(a) for a in fixture_rig())
    out = fixture_seeker().propose(
        pts, pmask, np.array([det], np.float32), np.array([1], np.int32),
        np.array([0.9], np.float32), np.array([0], np.int32),
        np.array([True]), l2i, c2l, intr, device="cpu")
    assert out.valid.numpy().sum() == 1 and int(out.labels[0]) == 1
    box = out.boxes[0].numpy()
    x_lo, x_hi = expected_final_x(fmin), expected_final_x(fmax)
    np.testing.assert_allclose(box[1:3], 0.0, atol=1e-3)
    np.testing.assert_allclose(box[3:6], [4.0, 2.0, 1.5], rtol=1e-5)
    np.testing.assert_allclose(box[6] % np.pi, 0.0, atol=1e-4)
    assert min(abs(box[0] - x_lo), abs(box[0] - x_hi)) < 2e-3


def test_frustum_bev_nms_matches_jax():
    rng = np.random.RandomState(10)
    d = 10
    frust = np.zeros((d, 8, 3), np.float32)
    base = rng.uniform(-30, 30, (d, 1, 3))
    frust[:] = base + rng.uniform(-6, 6, (d, 8, 3))
    frust[1] = frust[0] + 0.3                      # near-duplicate
    scores = rng.choice([0.5, 0.5, 0.9], d).astype(np.float32)
    labels = np.array([1, 1, 2, 1, 1, 2, 2, 1, 1, 1], np.int32)
    valid = np.arange(d) != 4
    kw = dict(class_names=CLASS_NAMES, nms_3d=0.3, bev_nms_grid=(60, 60))
    jx, pt = JaxOG(**kw), FrustumProposerOG(**kw)
    ref_m = np.asarray(jx.frustum_bev_masks(jnp.asarray(frust)))
    got_m = pt.frustum_bev_masks(tt(frust)).numpy()
    np.testing.assert_array_equal(got_m, ref_m)
    ref = np.asarray(jx.frustum_bev_nms(jnp.asarray(ref_m),
                                        jnp.asarray(scores),
                                        jnp.asarray(labels),
                                        jnp.asarray(valid)))
    got = pt.frustum_bev_nms(tt(got_m), tt(scores), tt(labels),
                             tt(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not ref.all()


def test_propose_on_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = rig_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        FrustumProposerOG(class_names=CLASS_NAMES).propose(
            *[scene[a] for a in ARGS])


def test_replace_keeps_own_constants():
    a = FrustumProposerOG(class_names=CLASS_NAMES, **SMALL)
    scene = rig_scene()
    a.propose(*[scene[k] for k in ARGS], device="cpu")
    b = dataclasses.replace(a, num_mags=3)
    out = b.propose(*[scene[k] for k in ARGS], device="cpu")
    assert out.boxes.shape == (8, 7) and b._consts is not a._consts
