"""The frustum query heads of the PyTorch port against the JAX package on
the same numpy-seeded inputs and weights: the host query builder on
tests/test_frustum_heads.py's camera scene, the heading codec, Frustum
PointNets v1 (eval forward, `frustum_pointnet_loss` and its gradients),
FrustumViTHead and FrustumPointNetHead (forward, the Hungarian-matched
loss with its tb, the gradients, the detections).

Weights and tolerances as tests/test_torch_mppnet.py's: the query
slabs, labels, matches and counts exact; outputs, losses and decoded
boxes 1e-4; gradients 1e-4 of each leaf's largest entry (a leaf whose
true gradient is zero, below 1e-5 of the largest).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.models import frustum_pointnets as tf
from findnpropagate_torch.models.dense_heads import DENSE_HEAD_REGISTRY
from findnpropagate_torch.models.dense_heads import frustum_heads as tfh
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.models import frustum_pointnets as jf
from findnpropagate_tpu.models.dense_heads import frustum_heads as jfh
from test_box_classification import BOXES3D
from test_frustum_heads import HEAD_CFG, _scene
from test_torch_mppnet import (
    TOL,
    close,
    flat,
    random_variables,
    same_grads,
    t,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def queries(num_proposals, max_points=64):
    l2i, points, dets, labels = _scene()
    args = (points, dets, labels, np.asarray([0.9, 0.8]),
            np.asarray([0, 0]), l2i[None])
    kw = {"num_proposals": num_proposals, "max_points": max_points}
    return tfh.build_frustum_queries(*args, **kw), \
        jfh.build_frustum_queries(*args, **kw)


def test_build_frustum_queries_matches_jax():
    got, want = queries(8)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["query_valid"].sum() == 2


def test_heading_codec_matches_jax():
    angles = np.asarray([0.0, 0.3, 1.9, -2.5, 3.1, 6.0, -7.0], np.float32)
    cls, res = tf.encode_heading(t(angles), 12)
    jcls, jres = jf.encode_heading(jnp.asarray(angles), 12)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    close(res, jres, tol=1e-6)
    rng = np.random.RandomState(2)
    scores = rng.standard_normal((3, 5, 12)).astype(np.float32)
    hres = rng.standard_normal((3, 5, 12)).astype(np.float32) * 0.2
    pre = rng.uniform(-3, 3, (3, 5)).astype(np.float32)
    close(tf.decode_heading(t(scores), t(hres), t(pre)),
          jf.decode_heading(jnp.asarray(scores), jnp.asarray(hres),
                            jnp.asarray(pre)), tol=1e-6)
    sizes = rng.standard_normal((3, 5, 3)).astype(np.float32)
    sres = rng.standard_normal((3, 5, 3, 3)).astype(np.float32) * 0.1
    anchors = np.asarray(tfh.FrustumPointNetHead.SIZE_ANCHORS, np.float32)
    close(tf.decode_size(t(sizes), t(sres), t(anchors)),
          jf.decode_size(jnp.asarray(sizes), jnp.asarray(sres),
                         jnp.asarray(anchors)), tol=1e-6)


ANCHORS = ((4.0, 1.8, 1.4), (0.8, 0.7, 1.7))


def fpn_case():
    rng = np.random.RandomState(1)
    b, n = 3, 96
    pts = np.concatenate([
        rng.uniform(-1, 1, (b, n // 2, 3)) * [2.0, 0.9, 0.7] + [10, 0, 0],
        rng.uniform(-4, 4, (b, n // 2, 3)) + [14, 0, 0]], 1).astype(
            np.float32)
    valid = np.ones((b, n), bool)
    valid[1, 70:] = False
    one_hot = np.eye(3, dtype=np.float32)[[0, 1, 0]]
    targets = {
        "seg": np.tile(np.r_[np.ones(n // 2), np.zeros(n // 2)],
                       (b, 1)).astype(np.int32),
        "center": np.asarray([[10, 0, 0], [10.2, 0.1, 0], [9.8, 0, 0.1]],
                             np.float32),
        "heading": np.asarray([0.4, -2.0, 3.0], np.float32),
        "size_cls": np.asarray([0, 1, 0], np.int32),
        "size": np.asarray([[4.0, 1.8, 1.4], [0.9, 0.6, 1.6],
                            [4.2, 1.7, 1.5]], np.float32),
        "point_valid": valid}
    return pts, valid, one_hot, targets


def test_frustum_pointnet_v1_forward_loss_and_gradients_match_jax():
    pts, valid, one_hot, targets = fpn_case()
    net = jf.FrustumPointNetv1(n_classes=3, size_anchors=ANCHORS)
    v = random_variables(lambda k, *a: net.init(k, *a, False),
                         jax.random.PRNGKey(0), jnp.asarray(pts),
                         jnp.asarray(one_hot), jnp.asarray(valid))
    jt = {k: jnp.asarray(x) for k, x in targets.items()}
    qvalid = jnp.asarray([True, True, False])

    def lf(p):
        out = net.apply({"params": p, "batch_stats": v["batch_stats"]},
                        jnp.asarray(pts), jnp.asarray(one_hot),
                        jnp.asarray(valid), False)
        total, parts = jf.frustum_pointnet_loss(out, jt, ANCHORS,
                                                valid=qvalid)
        return total, (out, parts)
    (loss, (out, parts)), grads = jax.jit(jax.value_and_grad(
        lf, has_aux=True))(v["params"])

    tnet = from_jax_variables(v, tf.FrustumPointNetv1(3, 12, ANCHORS)).eval()
    got = tnet(t(pts), t(one_hot), t(valid))
    for k, w in out.items():
        if k == "mask":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            close(got[k].detach(), w, msg=k)
    tl, tparts = tf.frustum_pointnet_loss(
        got, {k: t(x) for k, x in targets.items()}, ANCHORS,
        valid=t(np.asarray([True, True, False])))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(loss), rtol=TOL)
    for k, w in parts.items():
        np.testing.assert_allclose(float(tparts[k]), float(w), rtol=TOL,
                                   atol=1e-6, err_msg=k)
    same_grads(flat(to_jax_tree(tnet, "grad")), flat(grads))


def head_batch(num_proposals):
    q, _ = queries(num_proposals)
    batch = {k: v[None] for k, v in q.items()}
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, 0, :7] = BOXES3D[0]
    gt[0, 0, 7] = 1
    gt[0, 1, :7] = BOXES3D[1]
    gt[0, 1, 7] = 2
    batch["gt_boxes"] = gt
    return batch


@pytest.mark.parametrize("name", ["FrustumViTHead", "FrustumPointNetHead"])
def test_frustum_heads_forward_loss_and_detections_match_jax(name):
    cfg = copy.deepcopy(HEAD_CFG)
    batch = head_batch(8 if name == "FrustumViTHead" else 4)
    jhead = getattr(jfh, name)(model_cfg=cfg, num_class=10)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    v = random_variables(lambda k, b: jhead.init(k, b, False),
                         jax.random.PRNGKey(0), dict(jb))
    tools = jfh.make_frustum_head_tools(cfg, 10, class_names=["car",
                                                              "truck"])

    def lf(p):
        vv = {**v, "params": p}
        out = jhead.apply(vv, dict(jb), False)
        total, tb = tools.compute_loss(out)
        return total, (out["transfusion_preds"], tb)
    (loss, (res, tb)), grads = jax.jit(jax.value_and_grad(
        lf, has_aux=True))(v["params"])
    dets = tools.get_bboxes(res, max_det=8)

    thead = DENSE_HEAD_REGISTRY[name](cfg, None, 10, ["car", "truck"])
    from_jax_variables(v, thead).eval()
    out = thead({k: t(x) for k, x in batch.items()})
    tres = out["transfusion_preds"]
    # a padded query has no valid point: Frustum PointNets' masked max is
    # NEG_INF there, its outputs some 1e9 in both packages and the argmax
    # of its heading bins rounding noise; the loss and the detections
    # leave such slots out
    qv = batch["query_valid"][0]
    assert 0 < qv.sum() < len(qv)
    for k, w in res.items():
        if isinstance(w, dict):
            for kk, ww in w.items():
                close(tres[k][kk].detach()[:, qv], np.asarray(ww)[:, qv],
                      msg=f"{k}/{kk}")
        elif np.asarray(w).dtype in (np.int32, np.int64, bool):
            np.testing.assert_array_equal(tres[k].numpy(), np.asarray(w))
        else:
            close(tres[k].detach()[:, qv], np.asarray(w)[:, qv], msg=k)
    close(thead.tools.decode_boxes(tres).detach()[:, qv],
          np.asarray(tools.decode_boxes(res))[:, qv])
    tl, ttb = thead.compute_loss(out)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(loss), rtol=TOL)
    for k, w in tb.items():
        np.testing.assert_allclose(float(ttb[k]), float(w), rtol=TOL,
                                   atol=1e-6, err_msg=k)
    same_grads(flat(to_jax_tree(thead, "grad")), flat(grads))
    tdets = thead.get_bboxes(tres, max_det=8)
    np.testing.assert_array_equal(tdets.count.numpy(), np.asarray(dets.count))
    np.testing.assert_array_equal(tdets.labels.numpy(),
                                  np.asarray(dets.labels))
    close(tdets.boxes.detach(), dets.boxes)
    close(tdets.scores.detach(), dets.scores)
    assert int(tdets.count[0]) >= 1
