"""The anchor heads of the PyTorch port against the JAX package, on the same
numpy-seeded inputs and weights (the flax->torch weight bridge): the box
coders (ResidualCoder raw and sincos, with extra columns;
PointResidualCoder), `limit_period`, the aligned and nearest-BEV IoUs, the
anchor grid, the target assignment (nearest-BEV and 3D, ties on the
anchors, NORM_BY_NUM_EXAMPLES), AnchorHeadSingle (raw and sincos coder)
and AnchorHeadMulti with two groups (forward, loss and its tb, gradients),
the generic `post_process`, `class_agnostic_nms`, `multi_classes_nms`,
`circle_nms`, and two traits of the reference: a multi-head yaml cannot
be trained (its BOX_CODER_CONFIG under TARGET_ASSIGNER_CONFIG is not read,
so its 8 code weights meet a 7-wide code) and the yamls' keys that no
module reads.

Tolerances: anchors, nearest-BEV IoUs, assignment labels and weights,
NMS indices, counts and labels exact; regression targets and coder
outputs within 1e-6 (1e-5 where an exp or atan2 is taken); the aligned
rotated overlaps and IoUs within 3e-4 (float32 cancellation in the
shoelace sum at coordinates ~20 m, see the test); head outputs
and decoded boxes within 1e-5; the loss and its tb within 1e-5 relative;
gradients within 1e-4 of each leaf's largest entry plus rtol 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.config import EDict
from findnpropagate_torch.config import cfg_from_yaml_file
from findnpropagate_torch.models.dense_heads import anchor_generator as tgen
from findnpropagate_torch.models.dense_heads.anchor_head import (
    AnchorHeadSingle as TorchSingle,
)
from findnpropagate_torch.models.dense_heads.anchor_head import (
    make_anchor_head_tools as torch_tools,
)
from findnpropagate_torch.models.dense_heads.anchor_head_multi import (
    NEG_FILL,
)
from findnpropagate_torch.models.dense_heads.anchor_head_multi import (
    AnchorHeadMulti as TorchMulti,
)
from findnpropagate_torch.models.post_processing import (
    post_process as torch_post_process,
)
from findnpropagate_torch.ops import nms as tnms
from findnpropagate_torch.ops import rotated_iou as tiou
from findnpropagate_torch.utils import box_coders as tcod
from findnpropagate_torch.utils.geometry import limit_period as t_limit
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.models.dense_heads import anchor_generator as jgen
from findnpropagate_tpu.models.dense_heads.anchor_head import (
    AnchorHeadSingle,
    make_anchor_head_tools,
)
from findnpropagate_tpu.models.dense_heads.anchor_head_multi import (
    AnchorHeadMulti,
)
from findnpropagate_tpu.models.post_processing import post_process
from findnpropagate_tpu.ops import nms as jnms
from findnpropagate_tpu.ops import rotated_iou as jiou
from findnpropagate_tpu.utils import box_coders as jcod
from findnpropagate_tpu.utils.geometry import limit_period as j_limit

CLASSES = ("Car", "Pedestrian", "Cyclist")
GRID = (64, 48, 1)                       # stride 2 -> 32 x 24 map
PCR = (0.0, -9.6, -3.0, 25.6, 9.6, 1.0)
VOXEL = (0.4, 0.4, 4.0)
B = 2
C_IN = 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def t(x):
    return torch.from_numpy(np.array(x))


def head_cfg(multi=False, sincos=False, **kw):
    """The KITTI pointpillar.yaml head at stride 2, optionally grouped."""
    cfg = cfg_from_yaml_file("tools/cfgs/kitti_models/pointpillar.yaml"
                             ).MODEL.DENSE_HEAD
    if sincos:
        cfg.BOX_CODER_CONFIG = {"code_size": 7,
                                "encode_angle_by_sincos": True}
        cfg.LOSS_CONFIG.LOSS_WEIGHTS.code_weights = [1.0] * 8
    if multi:
        cfg.NAME = "AnchorHeadMulti"
        cfg.SHARED_CONV_NUM_FILTER = 8
        cfg.NUM_MIDDLE_CONV = 1
        cfg.RPN_HEAD_CFGS = [{"HEAD_CLS_NAME": ["Car"]},
                             {"HEAD_CLS_NAME": ["Pedestrian", "Cyclist"]}]
    cfg.update(kw)
    return cfg


# ---------------------------------------------------------------- coders


def random_boxes(rng, n, extra=0):
    b = np.zeros((n, 7 + extra), np.float32)
    b[:, 0:3] = rng.uniform(-20, 20, (n, 3))
    b[:, 3:6] = rng.uniform(0.3, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.uniform(-3, 3, (n, extra))
    return b


@pytest.mark.parametrize("sincos", [False, True])
@pytest.mark.parametrize("extra", [0, 2])
def test_residual_coder_matches_jax_and_round_trips(sincos, extra):
    rng = np.random.RandomState(extra + 2 * sincos)
    boxes, anchors = random_boxes(rng, 200, extra), random_boxes(rng, 200,
                                                                  extra)
    jc = jcod.ResidualCoder(code_size=7 + extra,
                            encode_angle_by_sincos=sincos)
    tc = tcod.ResidualCoder(code_size=7 + extra,
                            encode_angle_by_sincos=sincos)
    assert tc.full_code_size == jc.full_code_size
    enc = tc.encode(t(boxes), t(anchors))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jc.encode(
        jnp.asarray(boxes), jnp.asarray(anchors))), rtol=1e-6, atol=1e-6)
    codes = rng.standard_normal((200, jc.full_code_size)).astype(np.float32)
    np.testing.assert_allclose(
        tc.decode(t(codes), t(anchors)).numpy(),
        np.asarray(jc.decode(jnp.asarray(codes), jnp.asarray(anchors))),
        rtol=1e-5, atol=1e-5)
    back = tc.decode(enc, t(anchors)).numpy()
    heading = np.angle(np.exp(1j * (back[:, 6] - boxes[:, 6])))
    np.testing.assert_allclose(heading, 0, atol=1e-4)
    back[:, 6] = boxes[:, 6]
    np.testing.assert_allclose(back, boxes, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_mean_size", [True, False])
def test_point_residual_coder_matches_jax(use_mean_size):
    rng = np.random.RandomState(7)
    boxes, points = random_boxes(rng, 100, 2), random_boxes(rng, 100)[:, :3]
    classes = rng.randint(1, 4, 100)
    mean = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))
    jc = jcod.PointResidualCoder(use_mean_size=use_mean_size, mean_size=mean)
    tc = tcod.PointResidualCoder(use_mean_size=use_mean_size, mean_size=mean)
    enc = tc.encode(t(boxes), t(points), t(classes))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jc.encode(
        jnp.asarray(boxes), jnp.asarray(points), jnp.asarray(classes))),
        rtol=1e-6, atol=1e-6)
    back = tc.decode(enc, t(points), t(classes)).numpy()
    np.testing.assert_allclose(back, np.asarray(jc.decode(
        jnp.asarray(enc.numpy()), jnp.asarray(points),
        jnp.asarray(classes))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back, boxes, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- geometry


def test_limit_period_and_iou_helpers_match_jax():
    rng = np.random.RandomState(3)
    ang = np.concatenate([rng.uniform(-10, 10, 500),
                          np.arange(-8, 9) * np.pi / 4]).astype(np.float32)
    np.testing.assert_array_equal(t_limit(t(ang), 0, 2 * np.pi).numpy(),
                                  np.asarray(j_limit(jnp.asarray(ang), 0,
                                                     2 * np.pi)))
    np.testing.assert_array_equal(
        tiou.limit_period_half(t(ang)).numpy(),
        np.asarray(jiou.limit_period_half(jnp.asarray(ang))))
    a, b = random_boxes(rng, 300), random_boxes(rng, 40)
    b[:10] = a[:10]                      # identical pairs
    b[10:20, :3] = a[10:20, :3] + 0.3    # overlapping pairs
    np.testing.assert_array_equal(
        tiou.boxes_nearest_bev_iou(t(a), t(b)).numpy(),
        np.asarray(jiou.boxes_nearest_bev_iou(jnp.asarray(a),
                                              jnp.asarray(b))))
    # the shoelace sums cross products of corners ~20 m out: float32
    # cancellation, rounded differently where the reference's compiler
    # fuses a product into a sum, leaves ~1e-4 of an area of a few m^2
    for fn in ("boxes_aligned_overlap_bev", "boxes_aligned_iou3d"):
        got = getattr(tiou, fn)(t(a[:40]), t(b)).numpy()
        want = np.asarray(getattr(jiou, fn)(jnp.asarray(a[:40]),
                                            jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4,
                                   err_msg=fn)
        assert (want[:20] > 0).all()


# ---------------------------------------------------------------- anchors


@pytest.mark.parametrize("align_center", [False, True])
def test_anchors_match_jax(align_center):
    cfg = head_cfg().ANCHOR_GENERATOR_CONFIG
    for c in cfg:
        c["align_center"] = align_center
        c["anchor_bottom_heights"] = [-1.78, -0.6]
    got = tgen.generate_anchors(cfg, GRID, PCR)
    want = jgen.generate_anchors(copy.deepcopy(cfg), GRID, PCR)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[0].shape == (24, 32, 12, 7)


# ---------------------------------------------------------------- targets


def gt_boxes(rng, anchors, m=9):
    """(B, m, 8): boxes of every class, some copied from anchors (IoU 1),
    one between two anchors of a row (two anchors tie), one far outside
    (no overlap: never force-matched), two padding rows."""
    flat_a = anchors.reshape(-1, 7)
    gt = np.zeros((B, m, 8), np.float32)
    for b in range(B):
        n = m - 2
        gt[b, :n] = np.concatenate([random_boxes(rng, n), rng.randint(
            1, 4, (n, 1)).astype(np.float32)], -1)
        gt[b, :n, 0] = rng.uniform(1, 24, n)
        gt[b, :n, 1] = rng.uniform(-9, 9, n)
        gt[b, :n, 3:6] = np.array([3.9, 1.6, 1.56]) * rng.uniform(
            0.7, 1.3, (n, 3))
        k = rng.randint(len(flat_a))
        gt[b, 0, :7] = flat_a[k]
        gt[b, 0, 7] = 1 + k % 6 // 2          # that anchor's class
        gt[b, 1, :7] = (flat_a[6 * 40] + flat_a[6 * 41]) / 2
        gt[b, 1, 7] = 1
        gt[b, 2, 0] = 40.0
    return gt


@pytest.mark.parametrize("match_height", [False, True])
@pytest.mark.parametrize("norm", [False, True])
def test_assignment_matches_jax(match_height, norm, monkeypatch):
    """Labels and weights exact. With MATCH_HEIGHT (no yaml sets it) the
    port's assignment is fed the reference's 3D IoU: the two packages'
    float32 polygon intersections differ by up to ~1e-4 on the anchors'
    axis-aligned (degenerate) edges, which moves a label whose IoU lies at
    a threshold; the IoUs themselves are held to 2e-4 here."""
    if match_height:
        from findnpropagate_torch.models.dense_heads import target_assigner

        def reference_iou3d(a, b):
            want = np.asarray(jiou.boxes_iou3d(jnp.asarray(a.numpy()),
                                               jnp.asarray(b.numpy())))
            np.testing.assert_allclose(tiou.boxes_iou3d(a, b).numpy(), want,
                                       atol=2e-4)
            return t(want)

        monkeypatch.setattr(target_assigner, "boxes_iou3d", reference_iou3d)
    cfg = head_cfg()
    cfg.TARGET_ASSIGNER_CONFIG.MATCH_HEIGHT = match_height
    cfg.TARGET_ASSIGNER_CONFIG.NORM_BY_NUM_EXAMPLES = norm
    jt = make_anchor_head_tools(JEDict(copy.deepcopy(cfg)), 3, GRID, PCR)
    tt = torch_tools(copy.deepcopy(cfg), 3, GRID, PCR)
    np.testing.assert_array_equal(tt.anchors.numpy(), jt.anchors)
    gt = gt_boxes(np.random.RandomState(11 + match_height + 2 * norm),
                  jt.anchors)
    want = jax.tree.map(np.asarray, jt.assign(jnp.asarray(gt)))
    got = tt.assign(t(gt))
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(),
                                  want["box_cls_labels"])
    np.testing.assert_array_equal(got["reg_weights"].numpy(),
                                  want["reg_weights"])
    np.testing.assert_allclose(got["box_reg_targets"].numpy(),
                               want["box_reg_targets"], rtol=1e-6, atol=1e-6)
    labels = want["box_cls_labels"]
    assert (labels > 0).any() and (labels == -1).any() and (labels == 0).any()
    if not match_height:
        # the tied gt force-matches both anchors of its pair
        assert (labels[:, 6 * 40] == 1).all() and (labels[:, 6 * 41] == 1).all()


# ---------------------------------------------------------------- heads

HEADS = {"single": (False, False), "single_sincos": (False, True),
         "multi": (True, False)}


def head_pair(kind):
    multi, sincos = HEADS[kind]
    cfg = head_cfg(multi, sincos)
    jcls, tcls = (AnchorHeadMulti, TorchMulti) if multi \
        else (AnchorHeadSingle, TorchSingle)
    jhead = jcls(model_cfg=JEDict(copy.deepcopy(cfg)), input_channels=C_IN,
                 num_class=3, class_names=CLASSES, grid_size=GRID,
                 point_cloud_range=PCR, voxel_size=VOXEL)
    thead = tcls(copy.deepcopy(cfg), C_IN, 3, CLASSES, PCR, VOXEL, GRID)
    tools = make_anchor_head_tools(JEDict(copy.deepcopy(cfg)), 3, GRID, PCR)
    rng = np.random.RandomState(len(kind))
    x = rng.standard_normal((B, 24, 32, C_IN)).astype(np.float32)
    jb = {"spatial_features_2d": jnp.asarray(x)}
    shapes = jax.eval_shape(lambda b: jhead.init(jax.random.PRNGKey(0), b,
                                                 train=False), jb)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.2).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    from_jax_variables(variables, thead)
    tb = {"spatial_features_2d": t(x).permute(0, 3, 1, 2)}
    return cfg, jhead, thead, tools, variables, jb, tb


@pytest.mark.parametrize("kind", list(HEADS))
def test_anchor_head_matches_jax(kind):
    cfg, jhead, thead, tools, variables, jb, tb = head_pair(kind)
    with jax.default_matmul_precision("highest"):
        jout = jhead.apply(variables, dict(jb), train=False,
                           mutable=["batch_stats"])[0]
    with torch.no_grad():
        tout = thead.eval()(dict(tb))
    for k in ("cls_preds", "box_preds", "dir_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **TOL)
    if kind == "multi":
        cls = tout["cls_preds"].numpy().reshape(B, -1, 6, 3)
        assert (cls[:, :, 0:2, 1:] == NEG_FILL).all()
        assert (cls[:, :, 2:, 0] == NEG_FILL).all()

    gt = gt_boxes(np.random.RandomState(5), tools.anchors)

    def loss_fn(params):
        out, _ = jhead.apply({**variables, "params": params}, dict(jb),
                             train=True, mutable=["batch_stats"])
        out = dict(out)
        out["gt_boxes"] = jnp.asarray(gt)
        return tools.compute_loss(out)

    with jax.default_matmul_precision("highest"):
        (jloss, jtb), jgrad = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
    thead.train()
    out = thead(dict(tb))
    out["gt_boxes"] = t(gt)
    loss, ttb = thead.compute_loss(out)
    loss.backward()
    assert set(ttb) == set(jtb)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(ttb[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    got, want = flat(to_jax_tree(thead, "grad")), flat(jgrad)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(
            got[path], w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
            err_msg="/".join(path))


# ---------------------------------------------------------------- decode


def quantized_preds(seed, n=600, c=3):
    """Logits rounded to 1/16 (exact ties, as untrained heads give) and
    boxes clustered so that NMS suppresses."""
    rng = np.random.RandomState(seed)
    cls = np.round(rng.standard_normal((B, n, c)) * 32) / 16
    boxes = np.stack([random_boxes(rng, n) for _ in range(B)])
    boxes[..., :2] = rng.uniform(-8, 8, (B, n, 2))
    boxes[..., 3:5] = rng.uniform(1, 4, (B, n, 2))
    return cls.astype(np.float32), boxes


@pytest.mark.parametrize("normalized", [False, True])
def test_post_process_matches_jax(normalized):
    cls, boxes = quantized_preds(1)
    if normalized:
        cls = 1 / (1 + np.exp(-cls))
    want = post_process(jnp.asarray(cls), jnp.asarray(boxes), 0.1,
                        score_thresh=0.3, nms_pre=400, nms_post=60,
                        normalized=normalized)
    got = torch_post_process(t(cls), t(boxes), 0.1, score_thresh=0.3,
                             nms_pre=400, nms_post=60, normalized=normalized)
    assert 0 < int(got.count.min()) and int(got.count.max()) < 60
    for f in ("count", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL)


def test_class_agnostic_and_multi_class_nms_match_jax():
    cls, boxes = quantized_preds(2)
    scores = 1 / (1 + np.exp(-cls[0]))
    want = jnms.class_agnostic_nms(jnp.asarray(scores[:, 0]),
                                   jnp.asarray(boxes[0]), 0.2,
                                   score_thresh=0.4, pre_maxsize=300,
                                   post_maxsize=50)
    got = tnms.class_agnostic_nms(t(scores[:, 0]), t(boxes[0]), 0.2,
                                  score_thresh=0.4, pre_maxsize=300,
                                  post_maxsize=50)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    assert int(got[2]) == int(want[2]) > 0
    want = jnms.multi_classes_nms(jnp.asarray(scores), jnp.asarray(boxes[0]),
                                  0.2, score_thresh=0.4, pre_maxsize=300,
                                  post_maxsize=50)
    got = tnms.multi_classes_nms(t(scores), t(boxes[0]), 0.2,
                                 score_thresh=0.4, pre_maxsize=300,
                                 post_maxsize=50)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=str(i),
                                   **TOL)
    assert (got[3].numpy() > 0).all()


def test_circle_nms_matches_jax():
    rng = np.random.RandomState(4)
    centers = rng.uniform(-5, 5, (300, 2)).astype(np.float32)
    scores = (np.round(rng.uniform(0, 1, 300) * 20) / 20).astype(np.float32)
    want = jnms.circle_nms(jnp.asarray(centers), jnp.asarray(scores), 0.5,
                           post_maxsize=83)
    got = tnms.circle_nms(t(centers), t(scores), 0.5, post_maxsize=83)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) > 0


# ---------------------------------------------------------------- traits


def test_multihead_yaml_trains_in_neither_package():
    """lyft_models/cbgs_second_multihead.yaml's head on a small grid: the
    forwards agree, and the loss raises in both packages (8 code weights,
    a 7-wide code); the port's error names both lengths and the key."""
    cfg = cfg_from_yaml_file("tools/cfgs/lyft_models/cbgs_second_multihead"
                             ".yaml")
    head, names = cfg.MODEL.DENSE_HEAD, tuple(cfg.CLASS_NAMES)
    grid, pcr = (64, 64, 1), (-25.6, -25.6, -5.0, 25.6, 25.6, 3.0)
    jhead = AnchorHeadMulti(model_cfg=JEDict(copy.deepcopy(head)),
                            input_channels=C_IN, num_class=len(names),
                            class_names=names, grid_size=grid,
                            point_cloud_range=pcr)
    thead = TorchMulti(copy.deepcopy(head), C_IN, len(names), names, pcr,
                       VOXEL, grid)
    x = np.random.RandomState(0).standard_normal(
        (1, 8, 8, C_IN)).astype(np.float32)
    jb = {"spatial_features_2d": jnp.asarray(x)}
    variables = jhead.init(jax.random.PRNGKey(0), jb, train=False)
    from_jax_variables(jax.tree.map(np.asarray, variables), thead)
    with jax.default_matmul_precision("highest"):
        jout = jhead.apply(variables, dict(jb), train=False,
                           mutable=["batch_stats"])[0]
    tout = thead.eval()({"spatial_features_2d": t(x).permute(0, 3, 1, 2)})
    assert tout["box_preds"].shape[-1] == 7 and "dir_cls_preds" not in tout
    np.testing.assert_allclose(tout["batch_box_preds"].detach().numpy(),
                               np.asarray(jout["batch_box_preds"]), **TOL)
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, 0] = [1, 1, 0, 4.7, 1.9, 1.7, 0.3, 1]
    tools = make_anchor_head_tools(JEDict(copy.deepcopy(head)), len(names),
                                   grid, pcr)
    jtrain = dict(jout, gt_boxes=jnp.asarray(gt))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        tools.compute_loss(jtrain)
    tout["gt_boxes"] = t(gt)
    with pytest.raises(ValueError, match=r"8 values.*7 wide.*"
                       r"TARGET_ASSIGNER_CONFIG"):
        thead.compute_loss(tout)


class Recording(dict):
    """A config that records every key read through it."""

    def __init__(self, d, seen, prefix=""):
        super().__init__()
        self.seen, self.prefix = seen, prefix
        for k, v in d.items():
            dict.__setitem__(self, k, self.wrap(v, f"{prefix}{k}."))

    def wrap(self, v, prefix):
        if isinstance(v, dict):
            return Recording(v, self.seen, prefix)
        if isinstance(v, list):
            return [self.wrap(x, prefix) for x in v]
        return v

    def __getitem__(self, k):
        self.seen.add(self.prefix + k)
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        self.seen.add(self.prefix + k)
        return dict.get(self, k, default)

    def __contains__(self, k):
        self.seen.add(self.prefix + k)
        return dict.__contains__(self, k)

    def __getattr__(self, k):
        if k in ("seen", "prefix"):
            raise AttributeError(k)
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


UNREAD = ("POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS",
          "POST_PROCESSING.OUTPUT_RAW_SCORE",
          "DENSE_HEAD.LOSS_CONFIG.REG_LOSS_TYPE",
          "DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.pos_cls_weight",
          "DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.neg_cls_weight",
          "DENSE_HEAD.SEPARATE_REG_CONFIG", "DENSE_HEAD.USE_MULTIHEAD",
          "DENSE_HEAD.SEPARATE_MULTIHEAD",
          "DENSE_HEAD.TARGET_ASSIGNER_CONFIG.BOX_CODER_CONFIG")


def test_yaml_keys_no_module_reads():
    """The multi-head yamls' MULTI_CLASSES_NMS, REG_LOSS_TYPE,
    pos/neg_cls_weight, SEPARATE_REG_CONFIG, USE_MULTIHEAD,
    SEPARATE_MULTIHEAD and OUTPUT_RAW_SCORE (and the assigner's coder)
    are never read by the port's anchor detector, as by the reference's:
    a forward, post_process, assignment and loss touch none of them."""
    from findnpropagate_torch.models.detectors.detector3d import (
        DetectorModule,
    )

    cfg = cfg_from_yaml_file("tools/cfgs/nuscenes_models/cbgs_pp_multihead"
                             ".yaml")
    model = copy.deepcopy(cfg.MODEL)
    model.POST_PROCESSING.OUTPUT_RAW_SCORE = False
    model.DENSE_HEAD.SEPARATE_REG_CONFIG = {"NUM_MIDDLE_CONV": 1}
    model.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.code_weights = [1.0] * 7
    model.BACKBONE_2D.update({"LAYER_NUMS": [1, 1, 1],
                              "NUM_FILTERS": [8, 8, 8],
                              "NUM_UPSAMPLE_FILTERS": [8, 8, 8]})
    model.VFE.NUM_FILTERS = [8]
    model.MAP_TO_BEV.NUM_BEV_FEATURES = 8
    model.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 8
    seen = set()
    rec = Recording(model, seen)
    det = DetectorModule(rec, 10, tuple(cfg.CLASS_NAMES), (64, 64, 1),
                         (0.4, 0.4, 8.0), (-12.8, -12.8, -5.0, 12.8, 12.8,
                                           3.0), 5, 400, 8)
    rng = np.random.RandomState(0)
    pts = np.zeros((1, 500, 5), np.float32)
    pts[..., :3] = rng.uniform(-12, 12, (1, 500, 3))
    pts[..., 2] /= 4
    batch = {"points": t(pts), "points_mask": torch.ones(1, 500, dtype=bool)}
    with torch.no_grad():
        out = det.eval()(dict(batch))
        det.post_process(out)
    gt = np.zeros((1, 3, 10), np.float32)
    gt[0, 0, :7] = [1, 1, 0, 4.6, 1.9, 1.7, 0.3]
    gt[0, 0, 7] = 1          # the reference reads column 7 as the class
    loss, _ = det.train().loss(dict(batch, gt_boxes=t(gt)))
    assert torch.isfinite(loss)
    assert "POST_PROCESSING.NMS_CONFIG.NMS_THRESH" in seen
    assert "DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.code_weights" in seen
    for key in UNREAD:
        assert key not in seen, key
