"""CenterPoint of the PyTorch port against the JAX package, at narrow widths
on small grids, with the same numpy-seeded inputs and weights (the
flax->torch weight bridge): `topk_heatmap` (ties included),
VoxelBackBone8x in the port's four backbone modes, `CenterHead` with one
group and with the six groups of
tools/cfgs/nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml
(forward, target assignment, loss and its gradients, decode, the dense
decode of `predict_boxes_when_training`), `CenterHeadCLIP` (the same and its
embedding loss), `init_random_` against bench.py's `_random_variables` on a
CenterPoint tree, a narrow CenterPoint detector end to end (forward, loss
and post_process against Detector3D), and the DisableAugmentationHook on
the port's augmentor.

Tolerances: top-k, labels, cell indices, masks, counts and active counts
exact; head outputs, heatmap targets, target slots and boxes rtol / atol
1e-5, losses rtol 1e-4 (float32 on both sides, sums over the maps in
another order); gradients per
leaf within 1e-4 of the leaf's largest entry and 1e-6 of the largest
gradient of all, plus rtol 1e-4 (one BN with batch statistics and a few
dense layers; the biases ahead of a batch-statistic BN have a gradient of
0, rounding noise on both sides); the backbone's dense output 1e-4
(16 sparse and 6 dense convs, as tests/test_torch_backbone_modes.py); the
detector's head outputs and boxes 1e-4 (its backbone's 1e-4 carried
through the BEV backbone and the head), its loss rtol 1e-4. The JAX
detector runs its exact XLA windowed sparse convs (SUBM_IMPL: xla) at
highest matmul precision, its overflow asserted 0; the port runs the yaml's
own mode (pallas, the plain version of K3 on CPU tensors).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.augmentor.data_augmentor import (
    DataAugmentor as TorchAugmentor,
)
from findnpropagate_torch.datasets.synthetic import (
    SyntheticDataset,
    bench_data_cfg,
)
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.models.backbones_3d.spconv_backbone import (
    VoxelBackBone8x as TorchVoxelBackBone8x,
)
from findnpropagate_torch.models.dense_heads.center_head import (
    CenterHead as TorchCenterHead,
)
from findnpropagate_torch.models.dense_heads.center_head_clip import (
    CenterHeadCLIP as TorchCenterHeadCLIP,
)
from findnpropagate_torch.models.model_utils.centernet import (
    topk_heatmap as torch_topk,
)
from findnpropagate_torch.utils import metrics as torch_metrics
from findnpropagate_torch.utils.weights import (
    from_jax_variables,
    init_random_,
    to_jax_tree,
)
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.config import cfg_from_yaml_file
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.datasets.augmentor.data_augmentor import (
    DataAugmentor as JaxAugmentor,
)
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.models.backbones_3d import VoxelBackBone8x
from findnpropagate_tpu.models.dense_heads.center_head import (
    CenterHead,
    make_center_head_tools,
)
from findnpropagate_tpu.models.dense_heads.center_head_clip import (
    CenterHeadCLIP,
    make_center_head_clip_tools,
)
from findnpropagate_tpu.models.model_utils.centernet import topk_heatmap
from findnpropagate_tpu.utils import metrics as jax_metrics
from test_torch_backbone import GRID, _random_bn, make_batch
from test_torch_backbone_modes import BASE, MODES
from test_torch_transfusion import DATA

CP_YAML = "tools/cfgs/nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml"
CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
           "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone")
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


# ---------------------------------------------------------------- top-k


@pytest.mark.parametrize("kind", ["constant", "few_levels"])
def test_topk_heatmap_matches_jax_with_ties(kind):
    """A constant map ties every entry; a map of 3 levels ties within each:
    the port's order is jax.lax.top_k's, the lower flat index first."""
    rng = np.random.RandomState(0)
    shape = (2, 3, 9, 11)
    x = np.full(shape, 0.25, np.float32) if kind == "constant" else \
        rng.randint(0, 3, shape).astype(np.float32) / 4
    got = torch_topk(torch.from_numpy(x), 40)
    for b in range(shape[0]):
        want = topk_heatmap(jnp.asarray(x[b]), 40)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


# ---------------------------------------------------------------- backbone


@pytest.fixture(scope="module")
def backbone_setup():
    rng = np.random.RandomState(11)
    batch = make_batch(rng, 3, n=200, v_cap=300)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jbb(cfg):
        return VoxelBackBone8x(model_cfg=cfg, input_channels=4,
                               grid_size=GRID)

    variables = _random_bn(jbb(BASE).init(jax.random.PRNGKey(2), dict(jb),
                                          train=False), rng)
    variables = jax.tree.map(np.asarray, variables)
    refs = {}
    for name in ("gather", "xla"):
        out = jax.jit(lambda v, b, c=MODES[name]: {
            k: x for k, x in jbb(c).apply(v, b, train=False).items()
            if k in ("encoded_spconv_tensor", "sparse_active_counts",
                     "sparse_window_overflow")})(variables, jb)
        refs[name] = jax.tree.map(np.asarray, out)
    assert int(refs["xla"]["sparse_window_overflow"]) == 0
    return batch, variables, refs


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_voxel_backbone8x_matches_jax(backbone_setup, mode, b):
    """The plain variant (blocks{s}_conv{b}, no bias) in each mode of the
    port against the JAX gather backbone (batch 1: dense downsample, batch
    3: sort downsample); the JAX XLA windowed backbone agrees with it and
    reports overflow 0."""
    batch, variables, refs = backbone_setup
    ref = refs["gather"]
    np.testing.assert_allclose(refs["xla"]["encoded_spconv_tensor"],
                               ref["encoded_spconv_tensor"], rtol=1e-4,
                               atol=1e-4)
    tbb = TorchVoxelBackBone8x(MODES[mode], 4, GRID)
    assert not any("res" in n for n, _ in tbb.named_parameters())
    from_jax_variables(variables, tbb)
    with torch.no_grad():
        got = tbb.eval()({k: torch.from_numpy(v[:b])
                          for k, v in batch.items()})
    assert int(got["sparse_window_overflow"]) == 0
    if b == 3:
        np.testing.assert_array_equal(got["sparse_active_counts"].numpy(),
                                      ref["sparse_active_counts"])
    np.testing.assert_allclose(
        got["encoded_spconv_tensor"].permute(0, 2, 3, 4, 1).numpy(),
        ref["encoded_spconv_tensor"][:b], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- the heads

HEAD_GRID = (64, 48, 40)            # nx, ny, nz; stride 4 -> 12 x 16 map
HEAD_PCR = (-4.8, -3.6, -5.0, 4.8, 3.6, 3.0)
HEAD_VOXEL = (0.15, 0.15, 0.2)
HEAD_IN = 6
B = 2


def head_cfg(groups, vel=True, clip=False):
    cfg = cfg_from_yaml_file(CP_YAML).MODEL.DENSE_HEAD
    cfg.SHARED_CONV_CHANNEL = 8
    cfg.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE = 4
    pp = cfg.POST_PROCESSING
    pp.MAX_OBJ_PER_SAMPLE = 40
    pp.NMS_CONFIG.NMS_PRE_MAXSIZE = 100
    pp.NMS_CONFIG.NMS_POST_MAXSIZE = 30
    pp.POST_CENTER_LIMIT_RANGE = [-5.0, -3.0, -10.0, 5.0, 4.0, 10.0]
    if groups == 1:
        cfg.CLASS_NAMES_EACH_HEAD = None
    if not vel:
        cfg.SEPARATE_HEAD_CFG.HEAD_ORDER = ["center", "center_z", "dim",
                                            "rot"]
        del cfg.SEPARATE_HEAD_CFG.HEAD_DICT["vel"]
        cfg.LOSS_CONFIG.LOSS_WEIGHTS.code_weights = [1.0, 1.0, 0.2, 1.0,
                                                     1.0, 1.0, 1.0, 0.5]
    if clip:
        cfg.NAME = "CenterHeadCLIP"
        cfg.EMBED_DIM = 16
        cfg.LOSS_CONFIG.LOSS_WEIGHTS.emb_weight = 0.5
        pp.SCORE_THRESH = 0.3
    return cfg


def head_gt(rng, box_dim):
    """(B, 12, box_dim + 1): 10 boxes of random classes in range, two of
    them in the centre cell of another (repeated cell indices), two
    padding rows; one box far outside (clipped to the map's edge)."""
    m = 12
    gt = np.zeros((B, m, box_dim + 1), np.float32)
    for b in range(B):
        n = 10
        gt[b, :n, 0] = rng.uniform(-4.5, 4.5, n)
        gt[b, :n, 1] = rng.uniform(-3.4, 3.4, n)
        gt[b, :n, 2] = rng.uniform(-1.5, 0.5, n)
        gt[b, :n, 3:6] = rng.uniform(0.4, 4.0, (n, 3))
        gt[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        if box_dim > 7:
            gt[b, :n, 7:box_dim] = rng.uniform(-2, 2, (n, box_dim - 7))
        gt[b, 1, :2] = gt[b, 0, :2] + 0.01
        gt[b, 3, :2] = gt[b, 2, :2] - 0.02
        gt[b, 4, 0] = 9.0
        gt[b, :n, -1] = rng.randint(1, len(CLASSES) + 1, n)
    return gt


def bev_features(rng, occupied=10):
    """(B, 12, 16, HEAD_IN) BEV features that are 0 but in `occupied`
    cells a sample, as a scene's mostly empty map is: the empty cells'
    scores tie or nearly tie (see `quantized`)."""
    x = np.zeros((B, 12 * 16, HEAD_IN), np.float32)
    for b in range(B):
        cells = rng.choice(12 * 16, occupied, replace=False)
        x[b, cells] = 3 * rng.standard_normal((occupied, HEAD_IN))
    return x.reshape(B, 12, 16, HEAD_IN)


def make_heads(cfg, clip=False):
    jcls, tcls = (CenterHeadCLIP, TorchCenterHeadCLIP) if clip \
        else (CenterHead, TorchCenterHead)
    jhead = jcls(model_cfg=JEDict(copy.deepcopy(cfg)), input_channels=HEAD_IN,
                 num_class=len(CLASSES), class_names=CLASSES,
                 grid_size=HEAD_GRID, point_cloud_range=HEAD_PCR,
                 voxel_size=HEAD_VOXEL)
    maker = make_center_head_clip_tools if clip else make_center_head_tools
    tools = maker(JEDict(copy.deepcopy(cfg)), len(CLASSES), HEAD_GRID,
                  HEAD_PCR, HEAD_VOXEL, class_names=CLASSES)
    thead = tcls(copy.deepcopy(cfg), HEAD_IN, len(CLASSES), CLASSES,
                 HEAD_PCR, HEAD_VOXEL, HEAD_GRID)
    return jhead, tools, thead


def head_case(groups, vel, clip, box_dim):
    cfg = head_cfg(groups, vel, clip)
    jhead, tools, thead = make_heads(cfg, clip)
    rng = np.random.RandomState(groups * 10 + box_dim)
    x = bev_features(rng)
    gt = head_gt(rng, box_dim)
    jb = {"spatial_features_2d": jnp.asarray(x)}
    variables = jax.tree.map(np.asarray, bench._random_variables(
        _InitOnly(jhead), jb))
    from_jax_variables(variables, thead)
    tb = {"spatial_features_2d": torch.from_numpy(x).permute(0, 3, 1, 2)}
    return cfg, jhead, tools, thead, variables, jb, tb, gt


class _InitOnly:
    """bench._random_variables calls det.init(key, batch)."""

    def __init__(self, mod):
        self.mod = mod

    def init(self, key, batch):
        return self.mod.init(key, batch, train=False)


def quantized(preds):
    """Head outputs with the heatmap logits rounded to 1/64: equal scores
    tie exactly (both sides take the lower index first) and the others lie
    far more than a rounding step apart. Float32 sums in another order put
    a tie 1 ulp apart on one side only, so each side's own forward would
    order near-equal scores by its own rounding."""
    def one(p):
        return {k: np.round(np.asarray(v) * 64) / 64 if k == "hm"
                else np.array(v) for k, v in p.items()}
    return one(preds) if isinstance(preds, dict) else [one(p) for p in preds]


def check_decode(jdecode, tdecode, jout, key):
    """The JAX decode and the port's on the same (quantized) head outputs:
    counts and labels exact, boxes and scores within TOL."""
    q = quantized(jout[key])
    to_t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa
    jdets = jdecode({key: {k: jnp.asarray(v) for k, v in q.items()}
                     if isinstance(q, dict) else tuple(
                         {k: jnp.asarray(v) for k, v in p.items()}
                         for p in q)})
    tdets = tdecode({key: to_t(q) if isinstance(q, dict)
                     else tuple(to_t(p) for p in q)})
    np.testing.assert_array_equal(tdets.count.numpy(), np.asarray(jdets.count))
    assert int(tdets.count.min()) > 0
    np.testing.assert_array_equal(tdets.labels.numpy(),
                                  np.asarray(jdets.labels))
    np.testing.assert_allclose(tdets.boxes.numpy(), np.asarray(jdets.boxes),
                               **TOL)
    np.testing.assert_allclose(tdets.scores.numpy(),
                               np.asarray(jdets.scores), **TOL)
    return tdets


CASES = {
    # (groups, vel head, clip, gt box width)
    "six_groups": (6, True, False, 9),
    "one_group_no_vel": (1, False, False, 9),
    "one_group_7_value_boxes": (1, False, False, 7),
    "clip": (1, True, True, 9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_center_head_matches_jax(case):
    groups, vel, clip, box_dim = CASES[case]
    cfg, jhead, tools, thead, variables, jb, tb, gt = head_case(
        groups, vel, clip, box_dim)
    key = "center_clip_preds" if clip else "center_preds"

    # eval forward
    with jax.default_matmul_precision("highest"):
        jout = jhead.apply(variables, dict(jb), train=False)
    thead.eval()
    with torch.no_grad():
        tout = thead(dict(tb))
    groups_of = (lambda p: [p]) if clip else list
    for jg, tg in zip(groups_of(jout[key]), groups_of(tout[key])):
        assert set(jg) == set(tg)
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       err_msg=k, **TOL)
    check_decode(tools.get_bboxes, thead.get_bboxes, jout, key)

    # targets: the agnostic single class for the CLIP head, else per group
    tgt = torch.from_numpy(gt)
    if clip:
        agn = np.concatenate([gt[..., :-1], (gt[..., -1:] > 0)
                              .astype(np.float32)], -1)
        jt = [make_center_head_tools(
            JEDict(copy.deepcopy(cfg)), 1, HEAD_GRID, HEAD_PCR,
            HEAD_VOXEL).assign(jnp.asarray(agn))]
        tt = [thead.assign(torch.from_numpy(agn), num_classes=1)]
    else:
        garg = [None] if groups == 1 else list(tools.group_labels)
        jt = [tools.assign(jnp.asarray(gt), group=g) for g in garg]
        tt = [thead.assign(tgt, group=g) for g in garg]
    for (jh, jbx, ji, jm), (th, tbx, ti, tm) in zip(jt, tt):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tbx.numpy(), np.asarray(jbx), **TOL)
    assert sum(int(np.asarray(m).sum()) for *_, m in jt) == B * 10

    # loss and its gradients, BN on batch statistics
    def loss_fn(params, stats):
        out, mut = jhead.apply({"params": params, "batch_stats": stats},
                               dict(jb), train=True,
                               mutable=["batch_stats"])
        out = dict(out)
        out["gt_boxes"] = jnp.asarray(gt)
        total, tbd = tools.compute_loss(out)
        return total, tbd

    with jax.default_matmul_precision("highest"):
        (jloss, jtb), jgrad = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"],
                                    variables["batch_stats"])
    thead.train()
    out = thead(dict(tb))
    out["gt_boxes"] = tgt
    loss, ttb = thead.compute_loss(out)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    assert set(ttb) == set(jtb)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(ttb[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    if clip:
        assert float(ttb["emb_loss"]) > 0
    got, want = flat(to_jax_tree(thead, "grad")), flat(jgrad)
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        # a bias ahead of a batch-statistic BN has a gradient of 0:
        # rounding noise on both sides
        atol = max(1e-4 * float(np.abs(w).max()), 1e-6 * top)
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=atol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("clip", [False, True])
def test_velocity_head_with_7_value_boxes(clip):
    """7-value boxes (the data layer keeps no velocity) leave 8 target
    columns for a 10-wide code: the JAX loss fails on the shapes; the port
    leaves the velocity out of the regression loss, which equals the JAX
    loss on the same boxes with NaN velocities (reg_loss_centernet masks NaN
    targets), gradients included."""
    cfg, jhead, tools, thead, variables, jb, tb, gt = head_case(
        1, True, clip, 7)
    nan_vel = np.concatenate([gt[..., :7], np.full(gt.shape[:2] + (2,),
                                                   np.nan, np.float32),
                              gt[..., 7:]], -1)

    def loss_fn(params, stats, boxes):
        out, _ = jhead.apply({"params": params, "batch_stats": stats},
                             dict(jb), train=True, mutable=["batch_stats"])
        out = dict(out)
        out["gt_boxes"] = jnp.asarray(boxes)
        return tools.compute_loss(out)

    with pytest.raises(TypeError):
        loss_fn(variables["params"], variables["batch_stats"], gt)
    with jax.default_matmul_precision("highest"):
        (jloss, jtb), jgrad = jax.jit(jax.value_and_grad(
            lambda p, s: loss_fn(p, s, nan_vel), has_aux=True))(
                variables["params"], variables["batch_stats"])
    assert np.isfinite(float(jloss))
    out = thead.train()(dict(tb))
    out["gt_boxes"] = torch.from_numpy(gt)
    loss, ttb = thead.compute_loss(out)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(ttb[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    got, want = flat(to_jax_tree(thead, "grad")), flat(jgrad)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        atol = max(1e-4 * float(np.abs(w).max()), 1e-6 * top)
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=atol,
                                   err_msg="/".join(path))
    vel_out = [p for p in got if p[-2] == "vel_out"]
    assert vel_out and all(not np.abs(got[p]).any() for p in vel_out)


def test_predict_boxes_when_training_matches_jax():
    cfg = head_cfg(6)
    jhead, _, _ = make_heads(cfg)
    jhead = jhead.clone(predict_boxes_when_training=True)
    thead = TorchCenterHead(copy.deepcopy(cfg), HEAD_IN, len(CLASSES),
                            CLASSES, HEAD_PCR, HEAD_VOXEL, HEAD_GRID,
                            predict_boxes_when_training=True)
    x = bev_features(np.random.RandomState(4))
    jb = {"spatial_features_2d": jnp.asarray(x)}
    variables = jax.tree.map(np.asarray, bench._random_variables(
        _InitOnly(jhead), jb))
    from_jax_variables(variables, thead)
    with jax.default_matmul_precision("highest"):
        jout = jhead.apply(variables, dict(jb), train=False)
    with torch.no_grad():
        tout = thead.eval()({"spatial_features_2d": torch.from_numpy(
            x).permute(0, 3, 1, 2)})
    assert tout["cls_preds_normalized"] is True
    for k in ("batch_cls_preds", "batch_box_preds"):
        assert tuple(tout[k].shape) == jout[k].shape
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **TOL)


# ---------------------------------------------------------------- detector


def narrow_cfg(backbone="VoxelResBackBone8x"):
    cfg = cfg_from_yaml_file(CP_YAML)
    m = cfg.MODEL
    m.BACKBONE_3D.update({
        "NAME": backbone, "MAX_VOXELS": 2048,
        "LEVEL_CAPACITIES": [2048, 2048, 2048, 1024, 1024],
        "WINDOWED_BLOCK": 512, "WINDOWED_WINDOW": 2048,
        "WINDOWED_STRIDED_WINDOW": 4096,
        "CHANNELS": [16, 16, 16, 16, 16], "OUT_CHANNELS": 16,
        "DENSE_DTYPE": "f32"})
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                          "NUM_UPSAMPLE_FILTERS": [16, 16]})
    h = m.DENSE_HEAD
    h.SHARED_CONV_CHANNEL = 16
    h.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 60
    h.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 120
    h.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 40
    return cfg


@pytest.fixture(scope="module")
def detector_setup():
    cfg = narrow_cfg()
    data = copy.deepcopy(DATA)
    data["SYNTHETIC"]["NUM_OBJECTS"] = 12
    ds, _, _ = build_dataloader(JEDict(data), cfg.CLASS_NAMES, batch_size=B,
                                training=True, prefetch=0)
    batch = ds.collate_batch([ds[i] for i in range(B)])
    batch.pop("frame_id")
    batch.pop("batch_size")
    # nuScenes' 9-value boxes: velocities beside the synthetic 7 values
    gt = batch["gt_boxes"]
    vel = np.random.RandomState(9).uniform(-2, 2, gt.shape[:2] + (2,))
    batch["gt_boxes"] = np.concatenate(
        [gt[..., :7], (vel * (gt[..., -1:] > 0)).astype(np.float32),
         gt[..., 7:]], -1)
    jcfg = copy.deepcopy(cfg.MODEL)
    jcfg.BACKBONE_3D["SUBM_IMPL"] = "xla"
    jcfg.BACKBONE_3D["WINDOWED_PRECISION"] = "highest"
    jdet = jax_build(jcfg, num_class=10, dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, batch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, b: {k: x for k, x in jdet.apply(
            v, b, train=False).items() if k in (
                "center_preds", "sparse_active_counts",
                "sparse_window_overflow")})(variables, jb)
        loss, (ltb, _) = jax.jit(jdet.loss)(variables, jb)
    tds = SyntheticDataset(EDict(data), cfg.CLASS_NAMES, training=True)
    tdet = torch_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=tds,
                       device="cpu")
    return (cfg, ds, batch, variables, jax.tree.map(np.asarray, out), jdet,
            float(loss), {k: float(v) for k, v in ltb.items()}, tdet)


def test_centerpoint_detector_matches_jax(detector_setup):
    cfg, ds, batch, variables, out, jdet, jloss, jtb, tdet = detector_setup
    assert int(out["sparse_window_overflow"]) == 0
    from_jax_variables(variables, tdet)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tout = tdet.eval()(dict(tb))
        tdets = tdet.post_process(tout)
    assert int(tout["sparse_window_overflow"]) == 0
    np.testing.assert_array_equal(tout["sparse_active_counts"].numpy(),
                                  out["sparse_active_counts"])
    for jg, tg in zip(out["center_preds"], tout["center_preds"]):
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert tdets.boxes.shape == (B, 40, 9) and int(tdets.count.min()) > 0
    check_decode(jdet.post_process, tdet.post_process, out, "center_preds")

    det = copy.deepcopy(tdet).train()
    loss, ttb = det.loss(dict(tb))
    assert int(ttb["sparse_window_overflow"]) == 0
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    assert set(ttb) == set(jtb)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(ttb[k]), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("yaml", [
    CP_YAML, "tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml"])
def test_centerpoint_yamls_build_as_written(yaml):
    """Both nuScenes CenterPoint yamls build through the port's
    build_network at full width (nothing run: the full grid is for the
    card), with the JAX tree's leaves and shapes."""
    cfg = cfg_from_yaml_file(yaml)
    ds = SyntheticDataset(EDict(bench_cfg(cfg)), cfg.CLASS_NAMES,
                          training=False)
    det = torch_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=ds,
                      device="cpu")
    assert det.grid_size == tuple(int(g) for g in ds.grid_size)
    assert [int(g) for g in det.dense_head.group_labels[1]] == [2, 3]
    jdet = jax_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=ds)
    n_pts = int(ds.dataset_cfg.CAPACITIES.MAX_POINTS)
    shapes = jax.eval_shape(lambda b: jdet.init(jax.random.PRNGKey(0), b), {
        "points": jax.ShapeDtypeStruct((1, n_pts, 4), jnp.float32),
        "points_mask": jax.ShapeDtypeStruct((1, n_pts), jnp.bool_)})
    for coll in ("params", "batch_stats"):
        got = {k: v.shape for k, v in flat(to_jax_tree(
            det, "param" if coll == "params" else coll)).items()}
        want = {tuple(p.key for p in path): leaf.shape for path, leaf in
                jax.tree_util.tree_flatten_with_path(shapes[coll])[0]}
        assert got == want


def bench_cfg(cfg):
    voxel = next(p["VOXEL_SIZE"] for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p["NAME"] == "transform_points_to_voxels")
    return bench_data_cfg(1, cfg, voxel=list(voxel))


def test_init_random_matches_bench_on_a_centerpoint_tree(detector_setup):
    """init_random_ gives the port's CenterPoint (six head groups) the
    leaves bench.py's _random_variables gives the JAX one, in sorted-key
    order; and with VoxelBackBone8x and CenterHeadCLIP in its place."""
    cfg, ds, batch, variables, *_ , tdet = detector_setup
    init_random_(tdet, seed=0)
    for coll in ("params", "batch_stats"):
        got = flat(to_jax_tree(tdet, "param" if coll == "params" else coll))
        want = flat(variables[coll])
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w,
                                          err_msg="/".join(path))


@pytest.mark.parametrize("variant", ["VoxelBackBone8x", "CenterHeadCLIP"])
def test_init_random_matches_bench_on_variants(detector_setup, variant):
    cfg, ds, batch = detector_setup[:3]
    cfg = narrow_cfg("VoxelBackBone8x" if variant == "VoxelBackBone8x"
                     else "VoxelResBackBone8x")
    if variant == "CenterHeadCLIP":
        cfg.MODEL.DENSE_HEAD.NAME = "CenterHeadCLIP"
        cfg.MODEL.DENSE_HEAD.EMBED_DIM = 32
    jcfg = copy.deepcopy(cfg.MODEL)
    jcfg.BACKBONE_3D["SUBM_IMPL"] = "xla"
    jdet = jax_build(jcfg, num_class=10, dataset=ds)
    want = bench._random_variables(jdet, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    tds = SyntheticDataset(EDict(DATA), cfg.CLASS_NAMES, training=True)
    tdet = init_random_(torch_build(copy.deepcopy(cfg.MODEL), num_class=10,
                                    dataset=tds, device="cpu"), seed=0)
    for coll in ("params", "batch_stats"):
        got = flat(to_jax_tree(tdet, "param" if coll == "params" else coll))
        w = flat(want[coll])
        assert set(got) == set(w)
        for path in w:
            np.testing.assert_array_equal(got[path], np.asarray(w[path]),
                                          err_msg="/".join(path))


def test_unported_names_still_raise():
    cfg = narrow_cfg()
    tds = SyntheticDataset(EDict(DATA), cfg.CLASS_NAMES, training=False)
    for key, name in (("NAME", "CaDDN"), ("DENSE_HEAD", "PointHeadBox"),
                      ("BACKBONE_3D", "VoxelBackBone8xFocal")):
        m = copy.deepcopy(cfg.MODEL)
        if key == "NAME":
            m.NAME = name
        else:
            m[key].NAME = name
        with pytest.raises(NotImplementedError, match="item 15"):
            torch_build(m, num_class=10, dataset=tds, device="cpu")


# ---------------------------------------------------------------- the hook


def test_disable_augmentation_hook_matches_jax():
    """The hook strips the same queue entries from the port's augmentor as
    the JAX hook from the JAX one: methods by their config NAME, the
    database sampler as gt_sampling, only in the last NUM_LAST_EPOCHS."""
    aug_cfg = {"AUG_CONFIG_LIST": [
        {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
        {"NAME": "random_world_rotation",
         "WORLD_ROT_ANGLE": [-0.39, 0.39]},
        {"NAME": "random_world_scaling",
         "WORLD_SCALE_RANGE": [0.95, 1.05]}]}
    hook_cfg = {"DISABLE_AUG_LIST": ["random_world_rotation", "gt_sampling"],
                "NUM_LAST_EPOCHS": 2}

    class Loader:
        def __init__(self, aug):
            self.dataset = type("D", (), {"data_augmentor": aug})()

    names = {}
    for side, aug_cls, mod in (("jax", JaxAugmentor, jax_metrics),
                               ("torch", TorchAugmentor, torch_metrics)):
        aug = aug_cls(copy.deepcopy(aug_cfg), list(CLASSES))
        sampler = type("DataBaseSampler", (), {})()
        aug.queue.append(sampler)
        hook = mod.disable_augmentation_hook(hook_cfg, Loader(aug), 5)
        seen = []
        for epoch in range(5):
            hook(epoch)
            seen.append([torch_metrics.augmentation_key(f)[1]
                         for f in aug.queue])
        names[side] = seen
    assert names["torch"] == names["jax"]
    assert names["torch"][2] == ["random_world_flip", "random_world_rotation",
                                 "random_world_scaling", "gt_sampling"]
    assert names["torch"][3] == ["random_world_flip", "random_world_scaling"]
