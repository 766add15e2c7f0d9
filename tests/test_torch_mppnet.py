"""MPPNet of the PyTorch port against the JAX package on the same
numpy-seeded inputs and weights (the flax->torch weight bridge):

  * mppnet_utils: the grouped transformer on the 16-frame path (strided
    frame groups fused first), and the box branch;
  * the geometry helpers: anchors, spherical offsets, proxy grids, the
    trajectory (with tests/test_mppnet_e2e.py's loop oracle), the crop at
    its empty / full / back-fill corners, the pose transform;
  * `aug_rois_parallel` with the reference's draws handed in;
  * MPPNetHead through the detector (tests/test_mppnet_e2e.py's
    `_tiny_cfg` / `_make_batch`, run here without the `slow` mark): the
    eval forward, the detections, the training loss, its tb and the
    gradients at dropout 0 with the sampler's and the augmentations'
    draws handed in;
  * `post_process_mppnet` with and without NOT_APPLY_NMS_FOR_VEL;
  * MPPNetHeadE2E over three frames of the memory bank, and an offline
    head's weights loaded into it;
  * the Waymo USE_PREDBOX / SEQUENCE_CONFIG samples at 4 and 16 frames.

The JAX head draws from `make_rng("sampling")`; the tests pin it to KEY
and hand the port the draws the reference then makes.

Tolerances: indices, labels, counts and masks exact; boxes, features and
head outputs 1e-4 (2e-4 for the pose transform: the port's poses are
float64, the reference's float32); IoUs 3e-4 (the rotated IoU's float32
cancellation, tests/test_torch_roi_heads.py); losses rtol 1e-4; the
port's float64 gradients 1e-4 of each leaf's largest entry, a leaf whose
true gradient is zero only below 1e-5 of the largest gradient.
"""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.config import EDict as TEDict
from findnpropagate_torch.datasets.waymo import WaymoDataset as TWaymo
from findnpropagate_torch.models.detectors.detector3d import (
    build_detector as torch_build,
)
from findnpropagate_torch.models.model_utils import mppnet_utils as tu
from findnpropagate_torch.models.post_processing import (
    post_process_mppnet as t_post,
)
from findnpropagate_torch.models.roi_heads import mppnet_head as th
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict
from findnpropagate_tpu.datasets.waymo import WaymoDataset as JWaymo
from findnpropagate_tpu.models.detectors.detector3d import (
    build_detector as jax_build,
)
from findnpropagate_tpu.models.model_utils import mppnet_utils as ju
from findnpropagate_tpu.models.post_processing import (
    post_process_mppnet as j_post,
)
from findnpropagate_tpu.models.roi_heads import mppnet_head as jh
from test_mppnet_e2e import _DS, _make_batch, _tiny_cfg

KEY = jax.random.PRNGKey(11)
TOL = 1e-4
IOU_TOL = 3e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: tier-1 runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def random_variables(init, *args, seed=0):
    """Variables of a flax init's tree (traced for its shapes only, not
    run), from a numpy seed: kernels N(0, 1 / fan-in), norm scales 1 +
    N(0, 0.05^2), other parameters (biases, the transformer's token)
    N(0, 0.05^2); BN means 0 and variances 1."""
    shapes = jax.eval_shape(init, *args)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "mean":
            return jnp.zeros(s.shape, s.dtype)
        if name == "var":
            return jnp.ones(s.shape, s.dtype)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            x = x / np.sqrt(s.shape[0])
        else:
            x = x * 0.05 + (name == "scale")
        return jnp.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def same_grads(have, want, tol=TOL):
    """Every leaf within tol of its largest entry; a leaf whose true
    gradient is zero (an attention key's bias, a bias ahead of a LayerNorm
    over its broadcast axis or of a batch-statistic BN) only below 1e-5 of
    the largest gradient, as rounding noise. Returns those leaves."""
    assert set(have) == set(want)
    noise = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    zero = []
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if scale < noise:
            assert float(np.abs(have[k]).max()) < noise, k
            zero.append(k)
            continue
        np.testing.assert_allclose(have[k] / scale, w / scale, atol=tol,
                                   err_msg="/".join(k))
    return zero


def no_dropout(cfg):
    cfg = copy.deepcopy(cfg)
    cfg.ROI_HEAD.Transformer.dropout = 0.0
    return cfg


# ------------------------------------------------------------ mppnet_utils

TCFG = {"hidden_dim": 16, "num_groups": 4, "num_frames": 16,
        "num_proxy_points": 8, "enc_layers": 2, "dim_feedforward": 32,
        "nheads": 2, "sequence_stride": 4, "dropout": 0.0,
        "use_mlp_mixer": {"hidden_dim": 8}}


@pytest.mark.parametrize("pos", [False, True])
def test_grouped_transformer_16_frames_matches_jax(pos):
    rng = np.random.RandomState(0)
    src = rng.standard_normal((3, 16 * 8, 16)).astype(np.float32)
    p = rng.standard_normal((8, 16)).astype(np.float32) if pos else None
    jm = ju.MPPNetTransformer(model_cfg=TCFG, grid_size=2)
    jp = None if p is None else jnp.asarray(p)
    v = random_variables(lambda k, x: jm.init(k, x, jp, False),
                         jax.random.PRNGKey(0), jnp.asarray(src))
    hs, tokens = jax.jit(lambda v, x: jm.apply(v, x, jp, False))(
        v, jnp.asarray(src))
    tm = from_jax_variables(v, tu.MPPNetTransformer(TCFG, grid_size=2))
    ths, ttok = tm.eval()(t(src), None if p is None else t(p))
    assert ths.shape == (3, 4 * 16) and ttok.shape == (2, 3, 4, 16)
    close(ths.detach(), hs)
    close(ttok.detach(), tokens)


def test_seq_box_pointnet_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((5, 4, 8)).astype(np.float32)
    cfg = {"TRANS_INPUT": 32}
    jm = ju.SeqBoxPointNet(model_cfg=cfg, code_size=7)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    reg, feat = jm.apply(v, jnp.asarray(x), False)
    tm = from_jax_variables(v, tu.SeqBoxPointNet(cfg, 7))
    treg, tfeat = tm(t(x))
    close(treg.detach(), reg)
    close(tfeat.detach(), feat)


# -------------------------------------------------------------- geometry

def props(seed, b=2, f=4, r=6):
    rng = np.random.RandomState(seed)
    p = np.zeros((b, f, r, 9), np.float32)
    p[..., :2] = rng.uniform(-10, 10, (b, f, r, 2))
    p[..., 2] = 0.5
    p[..., 3:6] = rng.uniform(2, 4, (b, f, r, 3))
    p[..., 6] = rng.uniform(-np.pi, np.pi, (b, f, r))
    p[..., 7:9] = rng.uniform(-0.3, 0.3, (b, f, r, 2))
    # frame i>0: half the tracks continue the propagated frame-0 box
    p[:, 1:, :r // 2] = p[:, :1, :r // 2] + rng.normal(0, 0.05, (
        b, f - 1, r // 2, 9)).astype(np.float32)
    return p


def test_anchor_spherical_and_proxy_points_match_jax():
    rng = np.random.RandomState(0)
    boxes = props(0)[..., :7]
    pts = rng.uniform(-12, 12, (2, 4, 6, 5, 3)).astype(np.float32)
    anchors = jh.box_anchor_points(jnp.asarray(boxes))
    close(th.box_anchor_points(t(boxes)), anchors)
    diag = np.linalg.norm(boxes[..., 3:6], axis=-1)
    close(th.spherical_offsets(t(pts), th.box_anchor_points(t(boxes)),
                               t(diag)),
          jh.spherical_offsets(jnp.asarray(pts), anchors, jnp.asarray(diag)))
    for g in (2, 4):
        close(th.proxy_grid_points(t(boxes), g),
              jh.proxy_grid_points(jnp.asarray(boxes), g))


def test_trajectory_matches_jax_and_the_loop_oracle():
    p = props(3)
    valid = np.ones(p.shape[:3], bool)
    valid[1, 2, 4] = False
    valid[0, 0, 5] = False
    traj, vlen, assign = th.generate_trajectory(t(p), t(valid))
    jt, jv, ja = jax.vmap(jh.generate_trajectory)(jnp.asarray(p),
                                                   jnp.asarray(valid))
    close(traj, jt)
    np.testing.assert_array_equal(vlen.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
    assert vlen[:, 1:].any() and not vlen[:, 1:].all()
    # tests/test_mppnet_e2e.py's loop oracle (every proposal valid)
    from test_mppnet_e2e import _iou3d_np

    q = p[0]
    prev = q[0].copy()
    traj_all, vlen_all, _ = th.generate_trajectory(
        t(p[:1]), torch.ones(1, *p.shape[1:3], dtype=torch.bool))
    for i in range(1, q.shape[0]):
        pred = prev.copy()
        pred[:, 0:2] += pred[:, 7:9]
        iou = _iou3d_np(pred[:, :7], q[i][:, :7])
        ok = iou.max(1) >= 0.5
        cur = np.where(ok[:, None], q[i][iou.argmax(1)], pred)
        close(traj_all[0, i], cur)
        np.testing.assert_array_equal(vlen_all[0, i].numpy(), ok)
        prev = cur


def crop_case():
    """Point clouds with the crop's corners: a box without points, a box
    with fewer hits than slots (back-filled), a box with more (full), a
    masked-out hit and a box reached only by frame-1 points."""
    rng = np.random.RandomState(4)
    pts = rng.uniform(-20, 20, (2, 300, 6)).astype(np.float32)
    pts[..., 5] = rng.randint(0, 3, (2, 300)) * 0.1
    mask = np.ones((2, 300), bool)
    mask[:, 250:] = False
    boxes = np.zeros((2, 5, 7), np.float32)
    boxes[..., 3:6] = 2.0
    boxes[:, 0, :2] = (500.0, 0.0)                  # empty
    boxes[:, 1, :2] = pts[:, 10, :2]                # few hits
    boxes[:, 1, 3:5] = 0.3
    boxes[:, 2, :2] = (0.0, 0.0)                    # full
    boxes[:, 2, 3:5] = 30.0
    boxes[:, 3, :2] = pts[:, 260, :2]               # masked-out hits only
    boxes[:, 3, 3:5] = 0.05
    boxes[:, 4, :2] = pts[:, 5, :2]
    boxes[:, 4, 3:6] = (3.0, 3.0, 1.0)
    return pts, mask, boxes


@pytest.mark.parametrize("k", [1, 8, 64])
def test_crop_matches_jax_at_its_corners(k, monkeypatch):
    pts, mask, boxes = crop_case()
    crop, valid = th.crop_points_to_rois(t(pts), t(mask), t(boxes), k)
    for bi in range(2):
        jc, jv = jh.crop_points_to_rois(jnp.asarray(pts[bi]),
                                        jnp.asarray(mask[bi]),
                                        jnp.asarray(boxes[bi]), k)
        np.testing.assert_array_equal(crop[bi].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(valid[bi].numpy(), np.asarray(jv))
    n = valid.sum(-1)
    assert (n[:, 0] == 0).all() and (crop[:, 0] == 0).all()
    assert (n[:, 2] == k).all()
    if k == 64:
        assert ((n[:, 1] > 0) & (n[:, 1] < k)).all()
    # chunks of one ROI give the same crop
    monkeypatch.setattr(th, "CROP_CHUNK_ELEMS", 1)
    c1, v1 = th.crop_points_to_rois(t(pts), t(mask), t(boxes), k)
    assert torch.equal(c1, crop) and torch.equal(v1, valid)


def test_pose_transform_matches_jax():
    rng = np.random.RandomState(5)
    boxes = props(5)[0, 0]
    poses = []
    for yaw, x, y in ((0.3, 4.0, -2.0), (-1.1, 10.0, 3.0)):
        m = np.eye(4, dtype=np.float32)
        m[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        m[:3, 3] = (x, y, rng.uniform(-1, 1))
        poses.append(m)
    got = th.transform_boxes_to_current(t(boxes), t(poses[0]), t(poses[1]))
    want = jh.transform_boxes_to_current(jnp.asarray(boxes),
                                         jnp.asarray(poses[0]),
                                         jnp.asarray(poses[1]))
    assert got.dtype == torch.float32
    close(got, want, tol=2e-4)


def jax_aug_draws(key, t_, m):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (jax.random.uniform(k1, (t_, m, 3), minval=-0.5, maxval=0.5),
            1.0 + jax.random.uniform(k2, (t_, m, 3), minval=-0.15,
                                     maxval=0.15),
            jax.random.uniform(k3, (t_, m, 1), minval=-np.pi / 12,
                               maxval=np.pi / 12),
            jax.random.uniform(k4, (t_, m)))


def test_aug_rois_parallel_matches_jax_with_its_draws():
    p = props(6)
    rois = p[:, 0, :, :7]
    gt = rois + np.random.RandomState(6).normal(0, 0.1, rois.shape).astype(
        np.float32)
    src_iou = np.full(rois.shape[:2], 0.6, np.float32)
    keys = jax.random.split(KEY, 2)
    sel, ious, draws = [], [], []
    for bi in range(2):
        s, i = jh.aug_rois_parallel(keys[bi], jnp.asarray(rois[bi]),
                                    jnp.asarray(gt[bi]),
                                    jnp.asarray(src_iou[bi]), 10, 0.2, 0.55)
        sel.append(s)
        ious.append(i)
        draws.append(jax_aug_draws(keys[bi], 10, rois.shape[1]))
    d = tuple(t(np.stack([np.asarray(dr[j]) for dr in draws]))
              for j in range(4))
    got, got_iou = th.aug_rois_parallel(d, t(rois), t(gt), t(src_iou), 0.2,
                                        0.55)
    close(got, np.stack(sel))
    close(got_iou, np.stack(ious), tol=IOU_TOL)


# ------------------------------------------------------------------ head

def jbatch(seed=0, **kw):
    b = _make_batch(np.random.RandomState(seed), **kw)
    b.pop("batch_size")
    return b


def tbatch(b):
    return {k: t(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def mppnet():
    """The JAX detector at dropout 0 with its variables (the token and the
    zero-initialised leaves perturbed), its eval outputs and detections,
    and its training loss, tb and gradients with the sampling key pinned."""
    cfg = no_dropout(_tiny_cfg())
    jdet = jax_build(cfg, 3, _DS)
    batch = jbatch()
    v = random_variables(jdet.init, jax.random.PRNGKey(0), batch)
    out = jax.jit(lambda v, b: jdet.apply(v, b, train=False))(v, batch)
    dets = jdet.post_process(out)
    orig = jh.MPPNetHead.make_rng
    jh.MPPNetHead.make_rng = lambda self, name: KEY
    try:
        def lf(p, b):
            loss, (tb, mut) = jdet.loss({"params": p, "batch_stats":
                                         v["batch_stats"]}, b)
            return loss, (tb, mut)
        (loss, (tb, mut)), grads = jax.jit(jax.value_and_grad(
            lf, has_aux=True))(v["params"], batch)
    finally:
        jh.MPPNetHead.make_rng = orig
    return cfg, v, batch, out, dets, (loss, tb, grads, mut)


def mppnet_draws(cfg, b, r):
    """The reference's draws for its pinned key, as the port takes them."""
    tc = cfg.ROI_HEAD.TARGET_CONFIG
    s, times = int(tc.ROI_PER_IMAGE), int(tc.ROI_FG_AUG_TIMES)
    nf = int(cfg.ROI_HEAD.Transformer.num_frames)
    roi, aug, traj = [], [], []
    for key in jax.random.split(KEY, b):
        k_samp, k_aug, k_traj = jax.random.split(key, 3)
        roi.append(jax.random.uniform(k_samp, (r,)))
        aug.append(jax_aug_draws(k_aug, times, s))
        traj.append([jax_aug_draws(jax.random.fold_in(k_traj, fi), times, s)
                     for fi in range(1, nf)])

    def stack(ds):
        return tuple(t(np.stack([np.asarray(d[j]) for d in ds]))
                     for j in range(4))
    return {"roi": t(np.stack(roi)), "aug": stack(aug),
            "traj": [stack([tr[fi] for tr in traj])
                     for fi in range(nf - 1)]}


def port_mppnet(cfg, v):
    det = torch_build(copy.deepcopy(cfg), 3, _DS, device="cpu")
    return from_jax_variables(v, det)


def test_mppnet_eval_forward_and_detections_match_jax(mppnet):
    cfg, v, batch, out, dets, _ = mppnet
    det = port_mppnet(cfg, v)
    got = det(tbatch(batch))
    for k in ("rois", "roi_valid", "batch_roi_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(out[k]))
    for k in ("batch_box_preds", "batch_cls_preds"):
        close(got[k], out[k], msg=k)
    for k, want in out["mppnet_preds"].items():
        close(got["mppnet_preds"][k], want, msg=k)
    tdets = det.post_process(got)
    np.testing.assert_array_equal(tdets.count.numpy(), np.asarray(dets.count))
    np.testing.assert_array_equal(tdets.labels.numpy(),
                                  np.asarray(dets.labels))
    close(tdets.boxes, dets.boxes)
    close(tdets.scores, dets.scores)
    assert tdets.boxes.shape[-1] == 9 and int(tdets.count.sum()) > 0


def port_loss(cfg, v, batch, dtype):
    """The port's training loss in `dtype`, backward run, with the
    reference's draws."""
    det = port_mppnet(cfg, v).train().to(dtype)
    b = {k: x.to(dtype) if x.is_floating_point() else x
         for k, x in tbatch(batch).items()}
    b["mppnet_draws"] = mppnet_draws(cfg, 2, batch["roi_boxes"].shape[2])
    got, gtb = det.loss(b)
    got.backward()
    return det, float(got), gtb


def test_mppnet_training_loss_and_gradients_match_jax(mppnet):
    """The loss, its tb and the BN statistics in float32; the gradients of
    the port in float64 against the reference's float32: in float32 a
    pre-activation within rounding of zero can take the other side of a
    ReLU in either package, and one such element moves a hidden unit's
    gradient in its third digit (the port's float32 gradients differ from
    its own float64 ones by up to 2e-3 of a leaf here)."""
    cfg, v, batch, _, _, (loss, tb, grads, mut) = mppnet
    det, got, gtb = port_loss(cfg, v, batch, torch.float32)
    np.testing.assert_allclose(got, float(loss), rtol=TOL)
    assert set(gtb) == set(tb)
    for k in tb:
        np.testing.assert_allclose(float(gtb[k]), float(tb[k]), rtol=TOL,
                                   atol=1e-6, err_msg=k)
    stats = flat(to_jax_tree(det, "batch_stats"))
    for k, w in flat(mut["batch_stats"]).items():
        close(stats[k], w, msg="/".join(k))
    det64, got64, _ = port_loss(cfg, v, batch, torch.float64)
    np.testing.assert_allclose(got64, float(loss), rtol=TOL)
    zero = same_grads(flat(to_jax_tree(det64, "grad")), flat(grads))
    assert len(zero) < 0.1 * len(flat(grads))


def post_case(seed):
    rng = np.random.RandomState(seed)
    b, m = 2, 40
    boxes = np.zeros((b, m, 9), np.float32)
    boxes[..., :2] = rng.uniform(-6, 6, (b, m, 2))
    boxes[..., 3:6] = rng.uniform(1, 4, (b, m, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    boxes[..., 7:9] = rng.normal(0, 1, (b, m, 2))
    scores = rng.uniform(0, 1, (b, m)).astype(np.float32)
    labels = rng.randint(1, 4, (b, m)).astype(np.int32)
    valid = rng.uniform(size=(b, m)) > 0.1
    return boxes, scores, labels, valid


@pytest.mark.parametrize("no_vel_nms", [False, True])
@pytest.mark.parametrize("post", [8, 64])
def test_post_process_mppnet_matches_jax(no_vel_nms, post):
    boxes, scores, labels, valid = post_case(7)
    got = t_post(t(scores), t(boxes), t(labels), t(valid), 0.3,
                 score_thresh=0.2, nms_pre=32, nms_post=post,
                 not_apply_nms_for_vel=no_vel_nms)
    want = j_post(jnp.asarray(scores), jnp.asarray(boxes),
                  jnp.asarray(labels), jnp.asarray(valid), 0.3,
                  score_thresh=0.2, nms_pre=32, nms_post=post,
                  not_apply_nms_for_vel=no_vel_nms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.count.min()) > 0


# ------------------------------------------------------------ streaming

def e2e_frames(seed, b=1, r=6, n=400):
    rng = np.random.RandomState(seed)
    frames = []
    for step in range(3):
        rois11 = np.zeros((b, r, 11), np.float32)
        rois11[..., :2] = rng.uniform(-15, 15, (b, r, 2))
        if step:
            # most tracks continue last frame's boxes in the moved pose
            rois11[:, :4, :2] = frames[-1][0][:, :4, :2] - 1.0 \
                + rng.normal(0, 0.1, (b, 4, 2))
        rois11[..., 2] = 0.3
        rois11[..., 3:6] = rng.uniform(2, 4, (b, r, 3)) if not step \
            else frames[-1][0][..., 3:6]
        rois11[..., 6] = rng.uniform(-np.pi, np.pi, (b, r)) if not step \
            else frames[-1][0][..., 6]
        rois11[..., 9] = rng.uniform(0.3, 0.9, (b, r))
        rois11[..., 10] = rng.randint(1, 4, (b, r))
        pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        pose[:, 0, 3] = step * 1.0
        pts = rng.uniform(-20, 20, (b, n, 6)).astype(np.float32)
        pts[:, :120, :3] = rois11[:, np.arange(120) % r, :3] \
            + rng.normal(0, 0.6, (b, 120, 3))
        pts[..., 5] = 0.0
        frames.append((rois11, pose, pts))
    return frames


def test_e2e_head_over_three_memory_frames_matches_jax():
    cfg = no_dropout(_tiny_cfg()).ROI_HEAD
    jhead = jh.MPPNetHeadE2E(model_cfg=cfg, num_class=1)
    thead = th.MPPNetHeadE2E(cfg, num_class=1, num_point_features=6).eval()
    g_pts, hidden, nf = 8, 32, 4
    jmem = tmem = variables = None
    apply = jax.jit(lambda v, bt: jhead.apply(v, bt, False))
    for step, (rois11, pose, pts) in enumerate(e2e_frames(8)):
        if jmem is None:
            jmem = jh.init_mppnet_memory(jnp.asarray(rois11),
                                         jnp.asarray(pose), nf, g_pts, hidden)
            tmem = th.init_mppnet_memory(t(rois11), t(pose), nf, g_pts,
                                         hidden)
        else:
            jmem = jh.mppnet_e2e_push_rois(jmem, jnp.asarray(rois11),
                                           jnp.asarray(pose))
            tmem = th.mppnet_e2e_push_rois(tmem, t(rois11), t(pose))
        for k in ("rois", "poses", "feature"):
            close(tmem[k], jmem[k], msg=f"frame {step} memory {k}")
        jb = {"points": jnp.asarray(pts),
              "points_mask": jnp.ones(pts.shape[:2], bool),
              "memory_rois": jmem["rois"], "poses": jmem["poses"],
              "memory_feature": jmem["feature"],
              "sample_idx": jnp.full((1,), step, jnp.int32)}
        if variables is None:
            variables = random_variables(
                lambda k, bt: jhead.init(k, bt, False),
                jax.random.PRNGKey(0), jb)
            from_jax_variables(variables, thead)
        out = apply(variables, jb)
        tb = {"points": t(pts), "points_mask": torch.ones(pts.shape[:2],
                                                          dtype=torch.bool),
              "memory_rois": tmem["rois"], "poses": tmem["poses"],
              "memory_feature": tmem["feature"],
              "sample_idx": torch.full((1,), step, dtype=torch.int32)}
        got = thead(tb)
        for k in ("batch_box_preds", "batch_cls_preds",
                  "geometry_feature_memory"):
            close(got[k], out[k], msg=f"frame {step} {k}")
        for k in ("roi_valid", "batch_roi_labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(out[k]))
        jmem = jh.mppnet_e2e_push_feature(jmem,
                                          out["geometry_feature_memory"])
        tmem = th.mppnet_e2e_push_feature(tmem,
                                          got["geometry_feature_memory"])
    assert float(tmem["feature"][:, 0].abs().sum()) > 0
    with pytest.raises(RuntimeError, match="inference-only"):
        thead.train()(tb)


def test_offline_weights_load_into_the_e2e_head(mppnet):
    """The online head's leaves are the offline head's, so an offline
    tree (the JAX detector's roi_head) loads into the port's streaming
    head whole, as into the offline one."""
    cfg, v, *_ = mppnet
    roi = {"params": v["params"]["roi_head"],
           "batch_stats": v["batch_stats"]["roi_head"]}
    online = th.MPPNetHeadE2E(cfg.ROI_HEAD, num_class=1,
                              num_point_features=6)
    from_jax_variables(roi, online)
    offline = port_mppnet(cfg, v).roi_head
    assert online.state_dict().keys() == offline.state_dict().keys()
    for k, w in offline.state_dict().items():
        assert torch.equal(online.state_dict()[k], w), k


# ----------------------------------------------------------------- data

def waymo_tree(root, n_frames):
    seq = "segment-007"
    d = root / "waymo_processed_data" / seq
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    infos, preds = [], []
    for i in range(n_frames):
        p = np.zeros((100, 6), np.float32)
        p[:, :3] = rng.uniform(2, 10, (100, 3))
        p[:, 3:5] = rng.uniform(0, 1, (100, 2))
        p[:, 5] = -1
        np.save(str(d / f"{i:04d}.npy"), p)
        pose = np.eye(4)
        pose[:2, :2] = [[np.cos(0.05 * i), -np.sin(0.05 * i)],
                        [np.sin(0.05 * i), np.cos(0.05 * i)]]
        pose[0, 3] = i * 1.0
        infos.append({
            "point_cloud": {"lidar_sequence": seq, "sample_idx": i},
            "frame_id": f"{seq}_{i:03d}", "pose": pose,
            "annos": {"name": np.array(["Vehicle", "Cyclist"], dtype=object),
                      "gt_boxes_lidar": np.array(
                          [[5, 0, 0, 4, 2, 1.5, 0.2, 0, 0],
                           [8, 2, 0, 1.8, 0.6, 1.7, 1.0, 0, 0]], np.float32),
                      "num_points_in_gt": np.array([10, 5])}})
        k = 1 + i % 3
        preds.append({
            "frame_id": f"{seq}_{i:03d}",
            "boxes_lidar": rng.uniform(-1, 1, (k, 9)).astype(np.float32)
            + np.array([5, 0, 0, 4, 2, 1.5, 0, 1, 0], np.float32),
            "score": rng.uniform(0.2, 0.9, k),
            "name": np.array(["Vehicle", "Pedestrian", "Cyclist"][:k],
                             dtype=object)})
    with open(d / f"{seq}.pkl", "wb") as f:
        pickle.dump(infos, f)
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / "train.txt").write_text(seq + ".tfrecord\n")
    with open(root / "result.pkl", "wb") as f:
        pickle.dump(preds, f)


@pytest.mark.parametrize("offset,frames", [((-3, 0), 6), ((-15, 0), 18)])
def test_waymo_predbox_sequence_batches_match_jax(tmp_path, offset, frames):
    waymo_tree(tmp_path, frames)
    cfg = {
        "DATASET": "WaymoDataset",
        "DATA_SPLIT": {"train": "train", "test": "val"},
        "PROCESSED_DATA_TAG": "waymo_processed_data",
        "POINT_CLOUD_RANGE": [-50, -50, -3, 50, 50, 3],
        "SEQUENCE_CONFIG": {"ENABLED": True, "SAMPLE_OFFSET": list(offset)},
        "USE_PREDBOX": True, "MAX_ROIS": 8,
        "ROI_BOXES_PATH": {"train": str(tmp_path / "result.pkl")},
        "DISABLE_NLZ_FLAG_ON_POINTS": True,
        "CAPACITIES": {"MAX_POINTS": 4000, "MAX_GT": 8, "MAX_VOXELS": 10,
                       "MAX_POINTS_PER_VOXEL": 4},
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z", "intensity", "elongation",
                                  "time"],
            "src_feature_list": ["x", "y", "z", "intensity", "elongation",
                                 "time"]},
        "DATA_PROCESSOR": []}
    names = ["Vehicle", "Pedestrian", "Cyclist"]
    jds = JWaymo(EDict(copy.deepcopy(cfg)), names, training=True,
                 root_path=tmp_path)
    tds = TWaymo(TEDict(copy.deepcopy(cfg)), names, training=True,
                 root_path=tmp_path)
    nf = -offset[0] + 1
    for idx in (0, 2, frames - 1):
        js, ts = jds[idx], tds[idx]
        assert set(js) == set(ts)
        assert ts["roi_boxes"].shape == (nf, 8, 9)
        for k, w in js.items():
            if isinstance(w, np.ndarray) and w.dtype != object:
                np.testing.assert_array_equal(ts[k], w, err_msg=k)
    jb = jds.collate_batch([jds[frames - 1], jds[1]])
    tb = tds.collate_batch([tds[frames - 1], tds[1]])
    assert tb["roi_boxes"].shape == (2, nf, 8, 9)
    for k, w in jb.items():
        if isinstance(w, np.ndarray) and w.dtype != object:
            np.testing.assert_array_equal(tb[k], w, err_msg=k)
