"""The two-stage modules of the PyTorch port against the JAX package on the
same numpy-seeded inputs and weights (the flax->torch weight bridge):

  * the ROI template: `proposal_layer`, `sample_rois_for_rcnn` with the
    JAX draws handed in (both CLS_SCORE_TYPEs, with and without
    SAMPLE_ROI_BY_EACH_CLASS; every output key, `take` included),
    `canonicalize_gt_of_rois`, the two ROI losses, the gradient of the
    regression loss into the ROIs (a trait of the reference: the ROI
    losses reach the first stage through the ROIs), and
    `generate_predicted_boxes`; `post_process_two_stage`;
  * SALayer, VectorPoolLayer and `level_actives` (a dense level's
    compaction order), VoxelSetAbstraction with FPS and with PV-RCNN++'s
    sectorized proposal-centric keypoints, PointHeadSimple and its loss;
  * SECONDHead, PVRCNNHead and VoxelRCNNHead: eval forward, and the
    training forward + loss with DP_RATIO 0 (both packages compute the
    same thing) and the same ROI draws.

The JAX heads draw their ROI-sampling uniforms from `make_rng("sampling")`;
the tests pin that key (`pinned_sampling`) and hand the port the draws
`jax.random.uniform(split(key, B)[b], (M,))` the reference then makes.

Tolerances: indices, labels, counts and masks exact; the sampled ROIs'
IoUs and the labels made from them within 3e-4 (the rotated IoU's float32
cancellation, as in tests/test_torch_anchor_heads.py); boxes, features
and head outputs within 1e-5 (1e-4 after a BN over few valid rows in
training, whose variance divides small numbers); losses rtol 1e-5;
gradients 1e-5 of each leaf's scale.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.models.dense_heads import point_head_simple as tph
from findnpropagate_torch.models.pfe import voxel_set_abstraction as tvsa
from findnpropagate_torch.models.post_processing import (
    post_process_two_stage as t_post_two,
)
from findnpropagate_torch.models.roi_heads import pvrcnn_head as tpv
from findnpropagate_torch.models.roi_heads import roi_head_template as tt
from findnpropagate_torch.models.roi_heads import second_head as tsh
from findnpropagate_torch.models.roi_heads import voxelrcnn_head as tvr
from findnpropagate_torch.ops import nms as tnms
from findnpropagate_torch.utils.box_coders import ResidualCoder as TCoder
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict
from findnpropagate_tpu.models.dense_heads import point_head_simple as jph
from findnpropagate_tpu.models.pfe import voxel_set_abstraction as jvsa
from findnpropagate_tpu.models.post_processing import (
    post_process_two_stage as j_post_two,
)
from findnpropagate_tpu.models.roi_heads import pvrcnn_head as jpv
from findnpropagate_tpu.models.roi_heads import roi_head_template as jt
from findnpropagate_tpu.models.roi_heads import second_head as jsh
from findnpropagate_tpu.models.roi_heads import voxelrcnn_head as jvr
from findnpropagate_tpu.utils.box_coders import ResidualCoder as JCoder

B = 2
KEY = jax.random.PRNGKey(7)
TARGET = {"BOX_CODER": "ResidualCoder", "ROI_PER_IMAGE": 16,
          "FG_RATIO": 0.5, "SAMPLE_ROI_BY_EACH_CLASS": True,
          "CLS_SCORE_TYPE": "roi_iou", "CLS_FG_THRESH": 0.75,
          "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
          "HARD_BG_RATIO": 0.8, "REG_FG_THRESH": 0.55}
NMS = {"TRAIN": {"NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 48,
                 "NMS_THRESH": 0.8},
       "TEST": {"NMS_PRE_MAXSIZE": 48, "NMS_POST_MAXSIZE": 24,
                "NMS_THRESH": 0.7}}
LOSS = {"CLS_LOSS": "BinaryCrossEntropy", "REG_LOSS": "smooth-l1",
        "CORNER_LOSS_REGULARIZATION": True,
        "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                         "rcnn_corner_weight": 1.0, "rcnn_iou_weight": 1.0,
                         "code_weights": [1.0] * 7}}
PCR = (-12.8, -12.8, -3.0, 12.8, 12.8, 1.0)
VOXEL = (0.2, 0.2, 0.1)
SIZES = {1: (4.2, 1.8, 1.6), 2: (0.8, 0.7, 1.7)}
# the rotated 3D IoU's float32 cancellation (test_torch_anchor_heads.py)
IOU_TOL = 3e-4
IOU_KEYS = ("gt_iou_of_rois", "rcnn_cls_labels")


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
    return torch.from_numpy(np.array(x))


def close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def draws(m, key=KEY):
    """The uniforms the reference's sampler draws for each sample."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (m,)))(
        jax.random.split(key, B)))


@pytest.fixture
def pinned_sampling(monkeypatch):
    """Every JAX ROI stage's make_rng returns KEY."""
    from findnpropagate_tpu.models.detectors.detector3d import (
        RoIProposalStage,
    )

    for cls in (jsh.SECONDHead, jpv.PVRCNNHead, jvr.VoxelRCNNHead,
                RoIProposalStage):
        monkeypatch.setattr(cls, "make_rng", lambda self, name: KEY)


def gt_scene(seed, g=5):
    """(B, G, 8) ground truths (last column the label, a padded row in
    sample 1) and N first-stage boxes: jittered copies of each plus
    random ones, with random 2-class logits."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, g, 8), np.float32)
    for b in range(B):
        for i in range(g - b):
            lab = 1 + (i % 2)
            gt[b, i, :3] = (rng.uniform(-9, 9), rng.uniform(-9, 9),
                            rng.uniform(-1.5, -0.5))
            gt[b, i, 3:6] = SIZES[lab]
            gt[b, i, 6] = rng.uniform(-np.pi, np.pi)
            gt[b, i, 7] = lab
    boxes = []
    for b in range(B):
        rows = []
        for i in range(g - b):
            for s in (0.05, 0.2, 0.4, 0.8, 1.5, 2.5):
                bx = gt[b, i, :7].copy()
                bx[:3] += rng.randn(3) * s * np.array([1, 1, 0.3])
                bx[3:6] *= np.exp(rng.randn(3) * 0.1 * s)
                bx[6] += rng.randn() * 0.2 * s
                rows.append(bx)
            rows.append(rows[-6] * 1.001)     # suppressed by the NMS
        while len(rows) < 48:
            lab = rng.randint(1, 3)
            rows.append(np.array([rng.uniform(-11, 11), rng.uniform(-11, 11),
                                  -1.0, *SIZES[lab],
                                  rng.uniform(-3, 3)], np.float32))
        boxes.append(np.stack(rows))
    box_preds = np.stack(boxes).astype(np.float32)
    cls_preds = rng.randn(B, box_preds.shape[1], 2).astype(np.float32)
    return gt, cls_preds, box_preds


def jax_proposals(cls_preds, box_preds, nms_cfg):
    return jax.jit(jax.vmap(lambda c, b: jt.proposal_layer(c, b, nms_cfg)))(
        jnp.asarray(cls_preds), jnp.asarray(box_preds))


# ------------------------------------------------------------ template


def test_proposal_layer_matches_jax():
    _, cls_preds, box_preds = gt_scene(0)
    for nms_cfg in NMS.values():
        got = tt.proposal_layer(t(cls_preds), t(box_preds), nms_cfg)
        want = jax_proposals(cls_preds, box_preds, nms_cfg)
        close(got[0], want[0], msg="rois")
        close(got[1], want[1], msg="roi_scores")
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert int(got[3].sum()) > 0
        # the NMS suppresses some of the 48 candidates in TRAIN
        assert nms_cfg is NMS["TEST"] or not bool(got[3].all())


@pytest.mark.parametrize("score_type,by_class", [("roi_iou", True),
                                                 ("cls", True),
                                                 ("roi_iou", False)])
def test_sample_rois_matches_jax(score_type, by_class):
    gt, cls_preds, box_preds = gt_scene(1)
    cfg = dict(TARGET, CLS_SCORE_TYPE=score_type,
               SAMPLE_ROI_BY_EACH_CLASS=by_class)
    rois, scores, labels, valid = jax_proposals(cls_preds, box_preds,
                                                NMS["TRAIN"])
    r = draws(rois.shape[1])
    want = jax.jit(jax.vmap(lambda k, ro, sc, la, va, gb, gl, gv:
                            jt.sample_rois_for_rcnn(k, ro, sc, la, va, gb,
                                                    gl, gv, cfg)))(
        jax.random.split(KEY, B), rois, scores, labels, valid,
        jnp.asarray(gt[..., :7]), jnp.asarray(gt[..., 7]).astype(jnp.int32),
        jnp.asarray(gt[..., 7] > 0))
    got = tt.sample_rois_for_rcnn(
        t(r), t(rois), t(scores), t(labels).long(), t(valid),
        t(gt[..., :7]), t(gt[..., 7]).long(), t(gt[..., 7] > 0), cfg)
    assert set(got) == set(want)
    for k, v in want.items():
        if np.asarray(v).dtype.kind == "f":
            close(got[k], v, tol=IOU_TOL if k in IOU_KEYS else 1e-5, msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=k)
    # the scene yields foreground, hard and easy ROIs
    ious = got["gt_iou_of_rois"].numpy()
    assert (ious > 0.55).any() and ((ious > 0.1) & (ious < 0.55)).any()
    assert (got["rcnn_cls_labels"] == -1).any() == (score_type == "cls")


def test_canonical_targets_losses_and_decode_match_jax():
    rng = np.random.RandomState(2)
    gt, _, box_preds = gt_scene(2)
    rois = box_preds[:, :16]
    gt_src = np.repeat(gt[:, :4, :7], 4, axis=1)
    reg = (rng.randn(B, 16, 7) * 0.3).astype(np.float32)
    cls = rng.randn(B, 16, 1).astype(np.float32)
    labels = rng.uniform(-0.2, 1, (B, 16)).astype(np.float32)
    labels[labels < 0] = -1
    reg_valid = rng.rand(B, 16) > 0.4
    gct = tt.canonicalize_gt_of_rois(t(rois), t(gt_src))
    jgct = jax.jit(jax.vmap(jt.canonicalize_gt_of_rois))(
        jnp.asarray(rois), jnp.asarray(gt_src))
    close(gct, jgct, msg="canonical gt")
    out = {"rcnn_cls": t(cls), "rcnn_reg": t(reg), "rois": t(rois),
           "rcnn_targets": {"rcnn_cls_labels": t(labels),
                            "reg_valid_mask": t(reg_valid),
                            "gt_of_rois": gct, "gt_of_rois_src": t(gt_src)}}
    jout = {"rcnn_cls": cls, "rcnn_reg": reg, "rois": rois,
            "rcnn_targets": {"rcnn_cls_labels": labels,
                             "reg_valid_mask": reg_valid,
                             "gt_of_rois": jgct, "gt_of_rois_src": gt_src}}
    jout = jax.tree.map(jnp.asarray, jout)
    loss, tb = tt.two_stage_rcnn_loss(out, LOSS)
    jloss, jtb = jax.jit(lambda o: jpv.pvrcnn_rcnn_loss(o, LOSS))(jout)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(tb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=1e-5,
                                   err_msg=k)
    iou_out = {"rcnn_iou": t(cls), "rcnn_targets": {
        "rcnn_cls_labels": t(labels)}}
    for kind in ("BinaryCrossEntropy", "L2", "smoothL1"):
        cfg = dict(LOSS, IOU_LOSS=kind)
        got, _ = tsh.rcnn_iou_loss(iou_out, cfg)
        want, _ = jsh.rcnn_iou_loss(jax.tree.map(jnp.asarray, {
            "rcnn_iou": cls, "rcnn_targets": {"rcnn_cls_labels": labels}}),
            cfg)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    dec = tt.generate_predicted_boxes(t(rois), t(reg), TCoder())
    jdec = jax.jit(jax.vmap(lambda ro, rg: jt.generate_predicted_boxes(
        ro, rg, JCoder())))(jnp.asarray(rois), jnp.asarray(reg))
    close(dec, jdec, msg="decoded")


def test_reg_loss_gradient_reaches_the_rois():
    """The reference differentiates the regression and corner losses into
    the ROIs (their frame and anchors): the port's gradient equals it."""
    gt, _, box_preds = gt_scene(3)
    rois = box_preds[:, :12]
    gt_src = np.repeat(gt[:, :3, :7], 4, axis=1)
    reg = (np.random.RandomState(3).randn(B, 12, 7) * 0.2).astype(np.float32)
    valid = np.ones((B, 12), bool)
    valid[1, ::3] = False

    def jloss(ro):
        gct = jax.vmap(jt.canonicalize_gt_of_rois)(ro, jnp.asarray(gt_src))
        per, _ = jax.vmap(lambda a, b, c, d, e: jt.rcnn_reg_loss(
            b, a, c, d, e, LOSS, JCoder()))(ro, jnp.asarray(reg), gct,
                                            jnp.asarray(gt_src),
                                            jnp.asarray(valid))
        return jnp.mean(per)

    want = jax.jit(jax.grad(jloss))(jnp.asarray(rois))
    tr = t(rois).requires_grad_(True)
    per, _ = tt.rcnn_reg_loss(t(reg), tr, tt.canonicalize_gt_of_rois(
        tr, t(gt_src)), t(gt_src), t(valid), LOSS, TCoder())
    per.mean().backward()
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0
    close(tr.grad, want, tol=1e-5 * max(scale, 1.0), msg="d loss / d rois")


def test_post_process_two_stage_matches_jax():
    _, cls_preds, box_preds = gt_scene(4)
    rois, _, labels, valid = jax_proposals(cls_preds, box_preds,
                                           NMS["TEST"])
    scores = np.round(np.random.RandomState(4).randn(
        B, rois.shape[1], 1) * 16) / 16
    scores = scores.astype(np.float32)
    got = t_post_two(t(scores), t(rois), t(labels), t(valid), 0.1,
                     score_thresh=0.3, nms_pre=20, nms_post=10)
    want = j_post_two(jnp.asarray(scores), rois, labels, valid, 0.1,
                      score_thresh=0.3, nms_pre=20, nms_post=10)
    for f in ("count", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores"):
        close(getattr(got, f), getattr(want, f), msg=f)
    assert int(got.count.min()) > 0


# ------------------------------------------------------- modules / heads


def random_like(shapes, seed):
    """bench.py's N(0, 0.05^2) leaves for a variables tree of shapes, the
    BN statistics randomised too (mean around 0, var around 1) so eval
    mode is tested off the identity."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [p.key for p in path]
        val = rng.standard_normal(leaf.shape).astype(np.float32) * 0.05
        if keys[0] == "batch_stats":
            val = val * 4 + (1.0 if keys[-1] == "var" else 0.0)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return out


def jitted_apply(jmod, args):
    """jit of jmod.apply over the array leaves of `args` (the batch dicts
    also hold level kinds and shapes); non-array outputs come back None.
    One compile per mode costs less than JAX's eager dispatch here."""
    leaves, tree = jax.tree_util.tree_flatten(args)
    isarr = [isinstance(x, jax.Array) for x in leaves]

    def run(variables, arrs, train):
        it = iter(arrs)
        a = jax.tree_util.tree_unflatten(
            tree, [next(it) if f else x for x, f in zip(leaves, isarr)])
        out = jmod.apply(variables, *a, train, mutable=["batch_stats"],
                         rngs={"sampling": KEY})
        return jax.tree.map(
            lambda x: x if isinstance(x, jax.Array) else None, out)

    f = jax.jit(run, static_argnums=2)
    arrs = [x for x, flag in zip(leaves, isarr) if flag]
    return lambda variables, train: f(variables, arrs, train)


def both(jmod, tmod, args, targs, seed=0):
    """Random flax variables of the module's shapes, loaded into the
    port's; both run in eval and in training. Returns ((jeval, teval),
    (jtrain, ttrain), (jstats, tstats))."""
    def fresh(a):      # the modules write their outputs into a batch dict
        return [dict(x) if isinstance(x, dict) else x for x in a]

    variables = random_like(jax.eval_shape(lambda: jmod.init(
        {"params": KEY, "sampling": KEY}, *fresh(args), True)), seed)
    from_jax_variables(variables, tmod)
    apply = jitted_apply(jmod, fresh(args))
    with jax.default_matmul_precision("highest"):
        je, _ = apply(variables, False)
        jtr, mut = apply(variables, True)
    with torch.no_grad():
        te = tmod.eval()(*fresh(targs))
        ttr = tmod.train()(*fresh(targs))
    return (je, te), (jtr, ttr), (mut["batch_stats"],
                                  to_jax_tree(tmod, "batch_stats"))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def same_stats(js, ts, tol=1e-4):
    js, ts = flat(js), flat(ts)
    assert set(js) == set(ts) and js
    for k in js:
        close(ts[k], js[k], tol=tol, msg="/".join(k))


def sources(seed, v=120, c=6):
    rng = np.random.RandomState(seed)
    kp = rng.uniform(-3, 3, (B, 30, 3)).astype(np.float32)
    kpv = np.ones((B, 30), bool)
    kpv[1, -4:] = False
    src = rng.uniform(-3.5, 3.5, (B, v, 3)).astype(np.float32)
    srcv = rng.rand(B, v) > 0.2
    feats = rng.randn(B, v, c).astype(np.float32)
    return kp, kpv, src, srcv, feats


def test_sa_layer_matches_jax():
    kp, kpv, src, srcv, feats = sources(5)
    jm = jvsa.SALayer(mlps=((8, 8), (4,)), radii=(0.8, 1.6),
                      nsamples=(8, 4))
    tm = tvsa.SALayer(6, ((8, 8), (4,)), (0.8, 1.6), (8, 4))
    ev, tr, st = both(jm, tm, [jnp.asarray(a) for a in (kp, kpv, src, srcv,
                                                          feats)],
                      [t(a) for a in (kp, kpv, src, srcv, feats)])
    close(ev[1], ev[0], msg="eval")
    close(tr[1], tr[0], tol=1e-4, msg="train")
    same_stats(st[0], st[1])


def test_vector_pool_layer_matches_jax():
    kp, kpv, src, srcv, feats = sources(6)
    jm = jvsa.VectorPoolLayer(grid=2, radius=1.2, nsample=8, out_channels=5)
    tm = tvsa.VectorPoolLayer(6, 2, 1.2, 8, 5)
    ev, tr, st = both(jm, tm, [jnp.asarray(a) for a in (kp, kpv, src, srcv,
                                                          feats)],
                      [t(a) for a in (kp, kpv, src, srcv, feats)])
    close(ev[1], ev[0], msg="eval")
    close(tr[1], tr[0], tol=1e-4, msg="train")
    same_stats(st[0], st[1])


def dense_level(seed, shape=(3, 6, 5), c=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, *shape, c).astype(np.float32)
    m = rng.rand(B, *shape) > 0.6
    x = np.where(m[..., None], x, 0).astype(np.float32)
    return x, m


def win_level(seed, shape=(4, 40, 40), v=96, c=8):
    """A windowed level: ids, coords (zyx, -1 in the padded tail), valid,
    feats."""
    rng = np.random.RandomState(seed)
    coords = np.stack([rng.randint(0, n, (B, v)) for n in shape], -1)
    valid = np.ones((B, v), bool)
    valid[:, -10:] = False
    coords[~valid] = -1
    feats = np.where(valid[..., None], rng.randn(B, v, c), 0)
    ids = np.arange(B * v).reshape(B, v)
    return (ids.astype(np.int32), coords.astype(np.int32), valid,
            feats.astype(np.float32)), shape


@pytest.mark.parametrize("cap", [1000, 37])
def test_level_actives_dense_order(cap):
    """A dense level compacts to its active cells first, in flat (z, y, x)
    order, then the inactive ones, as the reference's top_k does."""
    x, m = dense_level(7)
    jc, jf, jv = jvsa.level_actives(("dense", jnp.asarray(x),
                                     jnp.asarray(m)), cap)
    tc, tf, tv = tvsa.level_actives(("dense", t(np.moveaxis(x, -1, 1)),
                                     t(m)), cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    close(tf, jf)


def vsa_cfg(method="FPS"):
    grp = {"MLPS": [[8, 8]], "POOL_RADIUS": [1.2], "NSAMPLE": [8]}
    cfg = {"NAME": "VoxelSetAbstraction", "NUM_KEYPOINTS": 48,
           "NUM_OUTPUT_FEATURES": 16, "SAMPLE_METHOD": method,
           "SPC_SAMPLING": {"NUM_SECTORS": 3, "SAMPLE_RADIUS_WITH_ROI": 1.6},
           "FEATURES_SOURCE": ["bev", "raw_points", "x_conv2", "x_conv3"],
           "SA_LAYER": {"raw_points": grp,
                        "x_conv2": {"DOWNSAMPLE_FACTOR": 2, **grp},
                        "x_conv3": {"DOWNSAMPLE_FACTOR": 4, **grp}}}
    if method == "SPC":
        vp = {"GRID_SIZE": 2, "POOL_RADIUS": 1.6, "NSAMPLE": 8,
              "OUT_CHANNELS": 6}
        cfg["SA_LAYER"]["x_conv3"]["VECTOR_POOL"] = vp
        # as the PV-RCNN++ yamls write it; the raw points take set
        # abstraction all the same (ROADMAP.md section 3, PR 16 (c))
        cfg["SA_LAYER"]["raw_points"] = dict(grp, VECTOR_POOL=vp)
    return EDict(cfg)


def vsa_batch(seed):
    """Points in the range, a BEV map of stride 8, a windowed x_conv2 and a
    dense x_conv3; the JAX and the port's layouts."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-6, 6, (B, 400, 2)),
                          rng.uniform(-2.5, 0.5, (B, 400, 1)),
                          rng.rand(B, 400, 1)], -1).astype(np.float32)
    pm = np.ones((B, 400), bool)
    pm[1, 350:] = False
    bev = rng.randn(B, 16, 16, 5).astype(np.float32)
    (ids, coords, valid, feats), shape2 = win_level(seed, (21, 64, 64), 200,
                                                    8)
    coords[..., 1:] = np.where(valid[..., None], coords[..., 1:] // 2 + 16,
                               -1)
    x3, m3 = dense_level(seed, (6, 16, 16), 4)
    jb = {"points": pts, "points_mask": pm, "spatial_features": bev,
          "spatial_features_stride": 8}
    tb = dict(jb, spatial_features=np.moveaxis(bev, -1, 1))
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in jb.items()}
    tb = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in tb.items()}
    jb["multi_scale_3d_features"] = {
        "x_conv2": ("win", tuple(jnp.asarray(a) for a in
                                 (ids, coords, valid, feats)), shape2),
        "x_conv3": ("dense", jnp.asarray(x3), jnp.asarray(m3))}
    tb["multi_scale_3d_features"] = {
        "x_conv2": ("win", tuple(t(a) for a in (ids, coords, valid, feats)),
                    shape2),
        "x_conv3": ("dense", t(np.moveaxis(x3, -1, 1)), t(m3))}
    return jb, tb


@pytest.mark.parametrize("method", ["FPS", "SPC"])
def test_voxel_set_abstraction_matches_jax(method):
    cfg = vsa_cfg(method)
    jb, tb = vsa_batch(8)
    if method == "SPC":
        gt, cls_preds, box_preds = gt_scene(8)
        box_preds[..., :2] *= 0.5
        rois, _, _, rv = jax_proposals(cls_preds, box_preds, NMS["TEST"])
        jb.update(rois=rois, roi_valid=rv)
        tb.update(rois=t(rois), roi_valid=t(rv))
    jm = jvsa.VoxelSetAbstraction(model_cfg=cfg, voxel_size=(0.2, 0.2, 0.1),
                                  point_cloud_range=(-6.4, -6.4, -3, 6.4,
                                                     6.4, 1))
    tm = tvsa.VoxelSetAbstraction(cfg, (0.2, 0.2, 0.1),
                                  (-6.4, -6.4, -3, 6.4, 6.4, 1), 4, 5,
                                  {"x_conv2": 8, "x_conv3": 4})
    ev, tr, st = both(jm, tm, [dict(jb)], [dict(tb)])
    for (j, tt_), tol in ((ev, 1e-5), ((tr[0], tr[1]), 1e-4)):
        for k in ("point_coords", "point_valid", "point_features",
                  "point_features_before_fusion"):
            close(tt_[k], j[k], tol=tol, msg=k)
    same_stats(st[0], st[1])
    kp_valid = np.asarray(ev[0]["point_valid"])
    assert kp_valid.all(axis=1).any()
    if method == "SPC":
        rois, rv = np.asarray(jb["rois"]), np.asarray(jb["roi_valid"])
        kp = np.asarray(ev[0]["point_coords"])
        for b in range(B):
            ctr = rois[b][rv[b], :3]
            rad = np.linalg.norm(rois[b][rv[b], 3:6], axis=-1) / 2 + 1.6
            d = np.linalg.norm(kp[b][:, None] - ctr[None], axis=-1)
            assert (d < rad + 1e-3).any(axis=1).mean() > 0.9


def test_point_head_simple_and_loss_match_jax():
    rng = np.random.RandomState(9)
    gt, _, _ = gt_scene(9)
    kp = np.concatenate([gt[:, :3, None, :3] + rng.randn(B, 3, 6, 3) * 0.8
                         for _ in range(1)], 2).reshape(B, 18, 3)
    kp = np.concatenate([kp, rng.uniform(-9, 9, (B, 12, 3))], 1).astype(
        np.float32)
    valid = np.ones((B, 30), bool)
    valid[0, -3:] = False
    feats = rng.randn(B, 30, 12).astype(np.float32)
    cfg = EDict({"NAME": "PointHeadSimple", "CLS_FC": [8, 8],
                 "USE_POINT_FEATURES_BEFORE_FUSION": True,
                 "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2]},
                 "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 2.0}}})
    jb = {"point_features_before_fusion": jnp.asarray(feats),
          "point_valid": jnp.asarray(valid), "point_coords": jnp.asarray(kp),
          "gt_boxes": jnp.asarray(gt)}
    tb = {k: t(np.asarray(v)) for k, v in jb.items()}
    ev, tr, st = both(jph.PointHeadSimple(model_cfg=cfg, input_channels=12),
                      tph.PointHeadSimple(cfg, 12), [dict(jb)], [dict(tb)])
    close(ev[1]["point_cls_logits"], ev[0]["point_cls_logits"])
    close(tr[1]["point_cls_scores"], tr[0]["point_cls_scores"], tol=1e-4)
    same_stats(st[0], st[1])
    for j, tt_ in (ev, (tr[0], tr[1])):
        want, jtb = jph.point_head_loss(j, cfg.LOSS_CONFIG, (0.2, 0.2, 0.2))
        got, ttb = tph.point_head_loss(tt_, cfg.LOSS_CONFIG, (0.2, 0.2, 0.2))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert set(ttb) == set(jtb)


def head_batch(seed):
    """A first stage (cls / box predictions), ground truths, a BEV map,
    keypoints with features and scores, and two windowed levels."""
    rng = np.random.RandomState(seed)
    gt, cls_preds, box_preds = gt_scene(seed)
    kp = rng.uniform(-11, 11, (B, 200, 3)).astype(np.float32)
    kp[..., 2] = rng.uniform(-2, 0, (B, 200))
    kpv = rng.rand(B, 200) > 0.1
    base = {"batch_cls_preds": cls_preds, "batch_box_preds": box_preds,
            "gt_boxes": gt, "point_coords": kp, "point_valid": kpv,
            "point_features": rng.randn(B, 200, 10).astype(np.float32),
            "point_cls_scores": rng.rand(B, 200).astype(np.float32)}
    bev = rng.randn(B, 32, 32, 6).astype(np.float32)
    levels_j, levels_t = {}, {}
    for name, stride, c in (("x_conv2", 2, 8), ("x_conv3", 4, 6)):
        n = 128 // stride
        (ids, coords, valid, feats), shape = win_level(
            seed + stride, (4, n, n), 400, c)
        levels_j[name] = ("win", tuple(jnp.asarray(a) for a in
                                       (ids, coords, valid, feats)), shape)
        levels_t[name] = ("win", tuple(t(a) for a in
                                       (ids, coords, valid, feats)), shape)
    jb = {k: jnp.asarray(v) for k, v in base.items()}
    tb = {k: t(v) for k, v in base.items()}
    jb.update(spatial_features_2d=jnp.asarray(bev),
              multi_scale_3d_features=levels_j)
    tb.update(spatial_features_2d=t(np.moveaxis(bev, -1, 1)),
              multi_scale_3d_features=levels_t)
    return jb, tb


HEADS = {
    "second": (jsh.SECONDHead, tsh.SECONDHead, {
        "SHARED_FC": [16, 16], "IOU_FC": [8],
        "ROI_GRID_POOL": {"GRID_SIZE": 3, "DOWNSAMPLE_RATIO": 4}},
        {"input_channels": 6}),
    "pvrcnn": (jpv.PVRCNNHead, tpv.PVRCNNHead, {
        "SHARED_FC": [16, 16], "CLS_FC": [8], "REG_FC": [8],
        "ROI_GRID_POOL": {"GRID_SIZE": 2, "MLPS": [[8, 8], [4]],
                          "POOL_RADIUS": [1.0, 2.0], "NSAMPLE": [8, 4]}},
        {"input_channels": 10}),
    "voxelrcnn": (jvr.VoxelRCNNHead, tvr.VoxelRCNNHead, {
        "SHARED_FC": [16, 16], "CLS_FC": [8, 8], "REG_FC": [8],
        "ROI_GRID_POOL": {
            "FEATURES_SOURCE": ["x_conv2", "x_conv3"], "GRID_SIZE": 2,
            "POOL_LAYERS": {
                "x_conv2": {"MLPS": [[8]], "POOL_RADIUS": [0.8],
                            "NSAMPLE": [8]},
                "x_conv3": {"MLPS": [[4, 4]], "POOL_RADIUS": [1.6],
                            "NSAMPLE": [4]}}}},
        {"level_channels": {"x_conv2": 8, "x_conv3": 6}}),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_roi_head_matches_jax(name, pinned_sampling):
    jcls, tcls, extra, kw = HEADS[name]
    cfg = EDict({"NAME": jcls.__name__, "CLASS_AGNOSTIC": True,
                 "DP_RATIO": 0.0, "NMS_CONFIG": NMS, "TARGET_CONFIG": TARGET,
                 "LOSS_CONFIG": dict(LOSS, IOU_LOSS="BinaryCrossEntropy"),
                 **extra})
    jb, tb = head_batch(10)
    tb["roi_draws"] = t(draws(NMS["TRAIN"]["NMS_POST_MAXSIZE"]))
    jm = jcls(model_cfg=cfg, point_cloud_range=PCR, voxel_size=VOXEL)
    tm = tcls(cfg, PCR, VOXEL, 1, **kw)
    ev, tr, st = both(jm, tm, [dict(jb)], [dict(tb)])
    keys = ("rois", "roi_labels", "roi_valid", "batch_cls_preds",
            "batch_box_preds", "batch_roi_labels")
    for k in keys:
        close(ev[1][k], ev[0][k], msg=k)
    assert int(ev[1]["roi_valid"].sum()) > 0
    jtr, ttr = tr[0], tr[1]
    for k in ("rois", "roi_labels", "roi_valid"):
        close(ttr[k], jtr[k], msg=k)
    for k, v in jtr["rcnn_targets"].items():
        close(ttr["rcnn_targets"][k], v,
              tol=IOU_TOL if k in IOU_KEYS else 1e-5, msg=k)
    out_key = "rcnn_iou" if name == "second" else "rcnn_reg"
    close(ttr[out_key], jtr[out_key], tol=1e-4, msg=out_key)
    same_stats(st[0], st[1])
    reg = ttr["rcnn_targets"]["reg_valid_mask"]
    assert bool(reg.any())
    if name == "second":
        want, jtb = jsh.rcnn_iou_loss(jtr, cfg.LOSS_CONFIG)
        got, ttb = tsh.rcnn_iou_loss(ttr, cfg.LOSS_CONFIG)
    else:
        want, jtb = jpv.pvrcnn_rcnn_loss(jtr, cfg.LOSS_CONFIG)
        got, ttb = tt.two_stage_rcnn_loss(ttr, cfg.LOSS_CONFIG)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(ttb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(ttb[k]), float(jtb[k]), rtol=1e-5,
                                   err_msg=k)


def test_top_k_orders_signed_zeros_apart_in_the_reference():
    """lax.top_k ranks +0.0 above -0.0 (a total order); the port's top-k,
    a stable sort, takes them as equal and keeps the lower index first
    (ROADMAP.md section 3, PR 16 (b)). Scores of exactly +-0 only meet in
    a tie made on purpose, as the detector tests' rounding does."""
    x = np.array([-0.0, 0.0, 1.0, -0.0], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(x), 4)
    _, tidx = tnms._top_k(t(x), 4)
    np.testing.assert_array_equal(np.asarray(jidx), [2, 1, 0, 3])
    np.testing.assert_array_equal(tidx.numpy(), [2, 0, 1, 3])


def test_voxel_rcnn_refuses_dense_levels():
    cfg = copy.deepcopy(HEADS["voxelrcnn"][2])
    cfg.update(NMS_CONFIG=NMS, TARGET_CONFIG=TARGET, DP_RATIO=0.0)
    tm = tvr.VoxelRCNNHead(EDict(cfg), PCR, VOXEL, 1,
                           level_channels={"x_conv2": 8, "x_conv3": 6})
    _, tb = head_batch(11)
    x, m = dense_level(11, (4, 32, 32), 6)
    tb["multi_scale_3d_features"]["x_conv3"] = ("dense", t(np.moveaxis(
        x, -1, 1)), t(m))
    with pytest.raises(ValueError, match="sparse/windowed"):
        tm.eval()(tb)
