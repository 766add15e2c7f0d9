"""Part-A2 and PointRCNN of the PyTorch port against the JAX package:

  * PointNet2MSG (set abstraction with FPS and ball query, feature
    propagation) in eval and training mode;
  * PartA2FCHead and PointRCNNHead on the same first stage, points and
    features, eval and training with the reference's ROI draws handed in
    (`roi_draws`), and their losses;
  * the detectors end to end at small size, on the same synthetic batch
    and weights (the flax->torch weight bridge): PointRCNN and
    PointRCNN-IoU (CLS_SCORE_TYPE roi_iou; the same forward) here,
    Part-A2 (UNetV2, anchor RPN, intra-part point head; also with the port
    in SUBM_IMPL posgather) and a PartA2_free-like model (no dense head:
    the point head's REG_FC boxes are the proposals) in
    tests/test_torch_parta2.py, which runs these helpers: the eval
    forward, the decoded detections, the training loss with its tb, and
    init_random_ against bench.py's recipe;
  * the six yamls of Part-A2 and PointRCNN build through build_network
    at full width (nothing run); every model yaml of tools/cfgs/ names
    only modules of the registries (the seekers' yamls are not models);
    and a voxel yaml without its VFE or dense head fails in the port
    where and as it fails in the JAX package (`outcomes`).

The models and data are tests/test_{parta2,pointrcnn}_e2e.py's (Part-A2's
on tests/test_voxelrcnn_e2e.py's data, at 1024 voxels a scene), whose
`slow` marks keep them out of tier-1. As in tests/test_torch_two_stage.py,
both packages' first-stage scores (batch_cls_preds, written by the dense
head or by the point head) are rounded to 1/16: untrained weights leave
them equal but for their last bits, and the proposal layer's order would
follow those bits. The JAX ROI heads' sampling key is pinned and the port
handed the same uniforms.

Tolerances: ROI labels, validity, point validity and detection counts
exact; ROIs, point coordinates, features, scores and head outputs within
1e-4 (float32 sums in another order through the sparse convs); the ROI
targets 3e-4 (the rotated IoU's float32 cancellation, as
tests/test_torch_roi_heads.py); the loss and its tb rtol 1e-4 (1e-5 for
the ROI heads alone); decoded detections from the same outputs (second
stage logits rounded to 1/16): counts and labels exact, boxes and scores
1e-5.
"""

import copy
import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import flax
from findnpropagate_torch.config import cfg_from_yaml_file
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.models.backbones_3d import pointnet2_backbone as tpn
from findnpropagate_torch.models.roi_heads import parta2_head as tpa
from findnpropagate_torch.models.roi_heads import pointrcnn_head as tpr
from findnpropagate_torch.models.roi_heads import roi_head_template as tt
from findnpropagate_torch.utils.weights import (
    from_jax_variables,
    init_random_,
    to_jax_tree,
)
from findnpropagate_torch.models import detectors as tdetectors
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.models import detectors as jdetectors
from findnpropagate_tpu.models.backbones_3d import pointnet2_backbone as jpn
from findnpropagate_tpu.models.detectors.detector3d import RoIProposalStage
from findnpropagate_tpu.models.roi_heads import ROI_HEAD_REGISTRY
from findnpropagate_tpu.models.roi_heads import parta2_head as jpa
from findnpropagate_tpu.models.roi_heads import pointrcnn_head as jpr
from test_parta2_e2e import MODEL_CFG as PA_E2E_MODEL
from test_pointrcnn_e2e import DATA_CFG as PR_DATA
from test_pointrcnn_e2e import MODEL_CFG as PR_MODEL
from test_torch_roi_heads import (
    B,
    KEY,
    LOSS,
    NMS,
    PCR,
    TARGET,
    VOXEL,
    close,
    draws,
    flat,
    gt_scene,
    random_like,
    same_stats,
    t,
)
from test_torch_two_stage import jax_round_stage1, torch_round_stage1
from test_voxelrcnn_e2e import DATA_CFG as PA_E2E_DATA

CLASSES = ("Car", "Pedestrian")
TOL = 1e-4
# Part-A2's e2e data and model at 1024 voxels a scene, with capacities
# that are multiples of every mode's block; levels 2 and 3 fill theirs,
# and both packages keep the same actives there (the JAX compile of the
# UNetV2 grows with the voxel count)
PA_DATA = copy.deepcopy(PA_E2E_DATA)
PA_DATA["CAPACITIES"]["MAX_VOXELS"] = 1024
PA_MODEL = copy.deepcopy(PA_E2E_MODEL)
PA_MODEL["BACKBONE_3D"]["LEVEL_CAPACITIES"] = [1024, 1024, 1024, 512, 512]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(jmod, tmod, jb, tb):
    """Random flax variables of the module's shapes (BN statistics off the
    identity), loaded into the port's; the JAX module's eval and training
    applies in one jit (cheaper to compile than two), the port's in eval
    and training. Returns ((jeval, teval), (jtrain, ttrain), (jstats,
    tstats))."""
    variables = random_like(jax.eval_shape(lambda: jmod.init(
        {"params": KEY, "sampling": KEY}, dict(jb), True)), 0)
    from_jax_variables(variables, tmod)

    def arrays(tree):
        return jax.tree.map(
            lambda x: x if isinstance(x, jax.Array) else None, tree)

    def run(v, b):
        ev = jmod.apply(v, dict(b), False, rngs={"sampling": KEY})
        tr, mut = jmod.apply(v, dict(b), True, mutable=["batch_stats"],
                             rngs={"sampling": KEY})
        return arrays(ev), arrays(tr), mut["batch_stats"]

    with jax.default_matmul_precision("highest"):
        je, jtr, jst = jax.jit(run)(variables, jb)
    with torch.no_grad():
        te = tmod.eval()(dict(tb))
        ttr = tmod.train()(dict(tb))
    return (je, te), (jtr, ttr), (jst, to_jax_tree(tmod, "batch_stats"))


@pytest.fixture
def pinned(monkeypatch):
    for cls in (jpa.PartA2FCHead, jpr.PointRCNNHead):
        monkeypatch.setattr(cls, "make_rng", lambda self, name: KEY)


# ------------------------------------------------------------ PointNet2MSG


def point_cloud(seed, p=400):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.randn(B, p // 2, 3) * 1.5,
                          rng.uniform(-8, 8, (B, p // 2, 3))], 1)
    feats = rng.rand(B, p, 1)
    mask = np.ones((B, p), bool)
    mask[1, -60:] = False
    return np.concatenate([pts, feats], -1).astype(np.float32), mask


def test_pointnet2_msg_matches_jax():
    cfg = JEDict(copy.deepcopy(PR_MODEL["BACKBONE_3D"]))
    pts, mask = point_cloud(0)
    jb = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    tb = {"points": t(pts), "points_mask": t(mask)}
    ev, tr, st = both(jpn.PointNet2MSG(model_cfg=cfg, input_channels=4),
                      tpn.PointNet2MSG(cfg, 4), jb, tb)
    for (j, g), tol in ((ev, TOL), (tr, TOL)):
        assert g["point_features"].shape == (B, 400, 32)
        close(g["point_features"], j["point_features"], tol=tol)
        np.testing.assert_array_equal(g["point_valid"].numpy(),
                                      np.asarray(j["point_valid"]))
    same_stats(st[0], st[1])
    assert float(ev[1]["point_features"].abs().sum()) > 0


# --------------------------------------------------------------- ROI heads


def head_batch(seed, part):
    """The ROI heads' inputs: a first stage (gt_scene), points with
    features, segmentation scores and (Part-A2) part offsets."""
    rng = np.random.RandomState(seed)
    gt, cls_preds, box_preds = gt_scene(seed)
    n = 600
    pts = np.concatenate([
        gt[:, :, None, :3] + rng.randn(B, gt.shape[1], n // 10, 3)
        * np.array([1.2, 1.2, 0.4]) for _ in range(2)], 2).reshape(B, -1, 3)
    pts = np.concatenate([pts, rng.uniform(-11, 11, (B, n - pts.shape[1],
                                                      3))], 1)
    base = {"batch_cls_preds": cls_preds, "batch_box_preds": box_preds,
            "gt_boxes": gt, "point_coords": pts.astype(np.float32),
            "point_valid": rng.rand(B, n) > 0.1,
            "point_features": rng.randn(B, n, 8).astype(np.float32),
            "point_cls_scores": rng.rand(B, n).astype(np.float32)}
    if part:
        base["point_part_offset"] = rng.rand(B, n, 3).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in base.items()},
            {k: t(v) for k, v in base.items()})


HEADS = {
    "parta2": (jpa.PartA2FCHead, tpa.PartA2FCHead, {
        "SHARED_FC": [16, 16], "CLS_FC": [8], "REG_FC": [8],
        "SEG_MASK_SCORE_THRESH": 0.3,
        "ROI_AWARE_POOL": {"POOL_SIZE": 4, "NUM_FEATURES": 16}}),
    "pointrcnn": (jpr.PointRCNNHead, tpr.PointRCNNHead, {
        "ROI_POINT_POOL": {"POOL_EXTRA_WIDTH": [0.2, 0.2, 0.2],
                           "NUM_SAMPLED_POINTS": 32,
                           "DEPTH_NORMALIZER": 70.0},
        "XYZ_UP_LAYER": [16, 16], "CLS_FC": [16], "REG_FC": [16],
        "USE_BN": False,
        "SA_CONFIG": {"NPOINTS": [16, 8, -1], "RADIUS": [0.4, 0.8, 100],
                      "NSAMPLE": [8, 8, 8],
                      "MLPS": [[16, 16], [16, 24], [24, 32]]}}),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_roi_head_matches_jax(name, pinned):
    jcls, tcls, extra = HEADS[name]
    cfg = JEDict({"NAME": jcls.__name__, "CLASS_AGNOSTIC": True,
                  "DP_RATIO": 0.0, "NMS_CONFIG": NMS, "TARGET_CONFIG": TARGET,
                  "LOSS_CONFIG": LOSS, **extra})
    jb, tb = head_batch(11, name == "parta2")
    tb["roi_draws"] = t(draws(NMS["TRAIN"]["NMS_POST_MAXSIZE"]))
    jm = jcls(model_cfg=cfg, point_cloud_range=PCR, voxel_size=VOXEL)
    tm = tcls(cfg, PCR, VOXEL, 1, input_channels=8)
    ev, tr, st = both(jm, tm, jb, tb)
    for k in ("rois", "roi_labels", "roi_valid", "batch_cls_preds",
              "batch_box_preds", "batch_roi_labels", "rcnn_reg"):
        close(ev[1][k], ev[0][k], tol=TOL, msg=k)
    assert int(ev[1]["roi_valid"].sum()) > 0
    jtr, ttr = tr
    for k in ("rois", "roi_labels", "roi_valid"):
        close(ttr[k], jtr[k], msg=k)
    for k, v in jtr["rcnn_targets"].items():
        close(ttr["rcnn_targets"][k], v, tol=3e-4, msg=k)
    close(ttr["rcnn_reg"], jtr["rcnn_reg"], tol=TOL)
    close(ttr["rcnn_cls"], jtr["rcnn_cls"], tol=TOL)
    same_stats(st[0], st[1])
    assert bool(ttr["rcnn_targets"]["reg_valid_mask"].any())
    want, jtb = getattr(jpa if name == "parta2" else jpr,
                        f"{name}_rcnn_loss")(jtr, cfg.LOSS_CONFIG)
    got, ttb = tt.two_stage_rcnn_loss(ttr, cfg.LOSS_CONFIG)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(ttb) == set(jtb)


# --------------------------------------------------------------- detectors


def free_model():
    """PartA2_free's topology at the e2e test's size: UNetV2, no dense
    head, the intra-part point head's box branch as the proposals."""
    m = copy.deepcopy(PA_MODEL)
    m["NAME"] = "PointRCNN"
    for k in ("MAP_TO_BEV", "BACKBONE_2D", "DENSE_HEAD"):
        del m[k]
    m["POINT_HEAD"].update(
        CLS_FC=[16], PART_FC=[16], REG_FC=[16],
        TARGET_CONFIG={"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2],
                       "BOX_CODER": "PointResidualCoder",
                       "BOX_CODER_CONFIG": {
                           "use_mean_size": True,
                           "mean_size": [[3.9, 1.6, 1.56],
                                         [0.8, 0.6, 1.73]]}})
    m["POINT_HEAD"]["LOSS_CONFIG"]["LOSS_WEIGHTS"]["point_box_weight"] = 1.0
    return m


def iou_model():
    m = copy.deepcopy(PR_MODEL)
    m["ROI_HEAD"]["TARGET_CONFIG"].update(
        CLS_SCORE_TYPE="roi_iou", CLS_FG_THRESH=0.7, CLS_BG_THRESH=0.25)
    return m


# label: (data, model, the port's SUBM_IMPL where it differs, the run
# whose JAX forward this one shares). Part-A2's three runs are
# tests/test_torch_parta2.py's
MODELS = {
    "pointrcnn": (PR_DATA, PR_MODEL, None, None),
    "pointrcnn_iou": (PR_DATA, iou_model(), None, "pointrcnn"),
    "parta2": (PA_DATA, PA_MODEL, None, None),
    "parta2_posgather": (PA_DATA, PA_MODEL, "posgather", "parta2"),
    "parta2_free": (PA_DATA, free_model(), None, None),
}
RUNS = ("pointrcnn", "pointrcnn_iou")
_JAX_RUNS = {}
OUT_KEYS = ("rois", "roi_labels", "roi_valid", "batch_cls_preds",
            "batch_box_preds", "batch_roi_labels", "point_valid",
            "point_coords", "point_features", "point_cls_scores",
            "point_part_offset", "rcnn_reg", "sparse_window_overflow")


def round_stage1(next_fun, args, kwargs, context):
    """jax_round_stage1 for the dense head and the point head alike."""
    if context.module.name == "point_head" \
            and context.method_name == "__call__":
        out = next_fun(*args, **kwargs)
        if "batch_cls_preds" in out:
            r = jnp.round(out["batch_cls_preds"] * 16) / 16
            out["batch_cls_preds"] = jnp.where(r == 0, 0.0, r)
        return out
    return jax_round_stage1(next_fun, args, kwargs, context)


def jax_run(label):
    """The JAX detector's batch, variables, eval outputs and loss (one run
    per model: the port's modes share it, and a model that differs from
    another in its ROI sampling alone shares that one's forward)."""
    if label in _JAX_RUNS:
        return _JAX_RUNS[label]
    data, model, _, same_forward = MODELS[label]
    if same_forward and MODELS[same_forward][1] is model:
        # the same JAX model: only the port's mode differs
        return jax_run(same_forward)
    if same_forward:
        # the same batch: the synthetic scenes draw from numpy's global
        # state
        ds, batch = jax_run(same_forward)[:2]
    else:
        ds, _, _ = build_dataloader(JEDict(copy.deepcopy(data)),
                                    list(CLASSES), batch_size=B,
                                    training=True, prefetch=0)
        batch = ds.collate_batch([ds[i] for i in range(B)])
        batch = {k: v for k, v in batch.items()
                 if isinstance(v, np.ndarray)}
    jdet = jax_build(JEDict(copy.deepcopy(model)), num_class=len(CLASSES),
                     dataset=ds)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def forward(v, b):
        out = jdet.apply(v, b, train=False)
        return {k: out[k] for k in OUT_KEYS if k in out}

    saved = {c: c.make_rng for c in (*ROI_HEAD_REGISTRY.values(),
                                     RoIProposalStage)}
    for c in saved:
        c.make_rng = lambda self, name: KEY
    try:
        with jax.default_matmul_precision("highest"), \
                flax.linen.intercept_methods(round_stage1):
            if same_forward:
                _, _, variables, out, *_ = jax_run(same_forward)
                loss, (ltb, _) = jax.jit(jdet.loss)(variables, jb)
            else:
                variables = jax.tree.map(np.asarray,
                                         bench._random_variables(jdet, batch))
                # one jit of both: compiles a quarter faster than two
                out, (loss, (ltb, _)) = jax.jit(lambda v, b: (
                    forward(v, b), jdet.loss(v, b)))(variables, jb)
                out = jax.tree.map(np.asarray, out)
    finally:
        for c, f in saved.items():
            c.make_rng = f
    _JAX_RUNS[label] = (ds, batch, variables, out, jdet, float(loss),
                        {k: float(v) for k, v in ltb.items()})
    return _JAX_RUNS[label]


def port_detector(label):
    """The port's detector of a run with the JAX run's weights, its first
    stage rounded as the JAX one, and the reference's ROI draws."""
    _, model, impl, _ = MODELS[label]
    ds, batch, variables, out, jdet, loss, ltb = jax_run(label)
    tmodel = copy.deepcopy(model)
    if impl is not None:
        tmodel["BACKBONE_3D"].update(SUBM_IMPL=impl, WINDOWED_BLOCK=512,
                                     WINDOWED_WINDOW=2048)
    tdet = torch_build(tmodel, num_class=len(CLASSES), dataset=ds,
                       device="cpu")
    from_jax_variables(variables, tdet)
    for mod in (tdet.dense_head, tdet.point_head):
        if mod is not None:
            mod.register_forward_hook(torch_round_stage1)
    m = int(model["ROI_HEAD"]["NMS_CONFIG"]["TRAIN"]["NMS_POST_MAXSIZE"])
    draws_ = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (m,)))(
        jax.random.split(KEY, B)))
    return (label, batch, variables, out, jdet, loss, ltb, tdet, draws_)


@pytest.fixture(scope="module", params=RUNS)
def detectors(request):
    return port_detector(request.param)


def test_forward_matches_jax(detectors):
    name, batch, _, out, _, _, _, tdet, _ = detectors
    with torch.no_grad():
        tout = tdet.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(out.get("sparse_window_overflow", 0)) == 0
    assert int(tout.get("sparse_window_overflow", 0)) == 0
    for k in OUT_KEYS[:-1]:
        assert (k in tout) == (k in out), k
        if k not in out:
            continue
        got = tout[k].numpy()
        if out[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got, out[k], err_msg=k)
        else:
            np.testing.assert_allclose(got, out[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    assert int(tout["roi_valid"].sum()) > 0
    assert ("point_part_offset" in tout) == name.startswith("parta2")


def test_detections_match_jax(detectors):
    _, _, _, out, jdet, *_, tdet, _ = detectors
    q = {k: out[k] for k in ("batch_cls_preds", "batch_box_preds",
                             "batch_roi_labels", "roi_valid")}
    q["batch_cls_preds"] = np.round(q["batch_cls_preds"] * 16) / 16
    q["rcnn_iou"] = q["batch_cls_preds"]
    want = jdet.post_process({k: jnp.asarray(v) for k, v in q.items()})
    got = tdet.post_process({k: torch.from_numpy(np.array(v))
                             for k, v in q.items()})
    for f in ("count", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5)
    assert np.isfinite(got.boxes.numpy()).all()


def test_loss_matches_jax(detectors):
    """The training loss with the reference's ROI draws: the first stage's
    (the dense head's, none in the point-based ones), the ROI head's and
    the point head's terms, each tb entry; gradients finite."""
    name, batch, _, _, _, jloss, jtb, tdet, draws_ = detectors
    det = copy.deepcopy(tdet).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["roi_draws"] = torch.from_numpy(draws_)
    loss, ttb = det.loss(tb)
    assert int(ttb.pop("sparse_window_overflow", 0)) == 0
    jtb = dict(jtb)
    assert int(jtb.pop("sparse_window_overflow", 0)) == 0
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=TOL)
    assert set(ttb) == set(jtb)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(ttb[k]), v, rtol=TOL, atol=1e-7,
                                   err_msg=k)
    assert "point_loss_part" in ttb if name.startswith("parta2") \
        else "point_loss_box" in ttb
    loss.backward()
    grads = [p.grad for p in det.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    # the first stage's box branch learns (by its own loss: PartA2_free's
    # point head has none, as in the reference)
    if name != "parta2_free":
        stage1 = det.dense_head if det.dense_head is not None \
            else det.point_head
        box = getattr(stage1, "conv_box", None) or stage1.reg_out
        assert float(box.weight.grad.abs().sum()) > 0


def test_init_random_matches_bench(detectors):
    _, _, variables, *_, tdet, _ = detectors
    det = copy.deepcopy(tdet)
    init_random_(det, seed=0)
    for coll in ("params", "batch_stats"):
        got = flat(to_jax_tree(det, "param" if coll == "params" else coll))
        want = flat(variables[coll])
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg="/".join(k))


# ------------------------------------------------------------------- yamls

YAMLS = ("kitti_models/PartA2", "kitti_models/PartA2_free",
         "kitti_models/pointrcnn", "kitti_models/pointrcnn_iou",
         "waymo_models/PartA2", "once_models/pointrcnn")
# the model yamls the port refuses: none since MPPNet (item 15.8)
REFUSED = ()
# refused before the focal backbone and the image stack (items 15.6, 15.7)
# and MPPNet (item 15.8)
PORTED_SINCE = ("kitti_models/CaDDN",
                "kitti_models/voxel_rcnn_car_focal_multimodal",
                "nuscenes_models/bevfusion", "waymo_models/mppnet_16frames",
                "waymo_models/mppnet_4frames",
                "waymo_models/mppnet_e2e_memorybank_inference")


def yaml_dataset(cfg):
    """What build_network reads of a dataset, from the yaml as written: no
    grid for a point-based DATA_PROCESSOR."""
    dc = cfg.DATA_CONFIG
    pcr = np.asarray(dc.POINT_CLOUD_RANGE, np.float32)
    voxel = next((p["VOXEL_SIZE"] for p in dc.DATA_PROCESSOR
                  if p["NAME"] == "transform_points_to_voxels"), None)
    caps = dc.get("CAPACITIES", {})
    return types.SimpleNamespace(
        class_names=list(cfg.CLASS_NAMES), point_cloud_range=pcr,
        voxel_size=None if voxel is None else list(voxel),
        grid_size=None if voxel is None else tuple(np.round(
            (pcr[3:] - pcr[:3]) / np.asarray(voxel, np.float32)).astype(int)),
        num_point_features=len(dc.POINT_FEATURE_ENCODING.used_feature_list),
        max_voxels=int(caps.get("MAX_VOXELS", 1000)),
        max_points_per_voxel=int(caps.get("MAX_POINTS_PER_VOXEL", 5)))


@pytest.mark.parametrize("yaml", YAMLS)
def test_parta2_and_pointrcnn_yamls_build_as_written(yaml):
    cfg = cfg_from_yaml_file(f"tools/cfgs/{yaml}.yaml")
    ds = yaml_dataset(cfg)
    det = torch_build(copy.deepcopy(cfg.MODEL), len(cfg.CLASS_NAMES), ds,
                      device="cpu")
    m = cfg.MODEL
    bb = m.BACKBONE_3D.NAME
    assert type(det.backbone_3d).__name__ == bb
    assert type(det.roi_head).__name__ == m.ROI_HEAD.NAME
    assert type(det.point_head).__name__ == m.POINT_HEAD.NAME
    assert (det.dense_head is not None) == ("DENSE_HEAD" in m)
    assert det.voxelized == ("VFE" in m) == (ds.grid_size is not None)
    if bb == "UNetV2":
        assert det.backbone_3d.num_point_features == 16
        assert det.roi_head.conv_rpn.conv0.in_channels == 16
    else:
        assert det.roi_head.merge_down.fc0.in_features == 128 + 128
    assert not det.training


def fake_batch(ds, n=300, seed=0):
    """n points uniform over the dataset's range with its point features,
    and four 2 m ground truths of class 1 centred on the first of them."""
    rng = np.random.RandomState(seed)
    pcr = np.asarray(ds.point_cloud_range, np.float32)
    xyz = rng.uniform(pcr[:3], pcr[3:], (1, n, 3)).astype(np.float32)
    pts = np.concatenate([xyz, rng.rand(
        1, n, ds.num_point_features - 3).astype(np.float32)], -1)
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, :, :3] = xyz[0, :4]
    gt[0, :, 3:6] = 2.0
    gt[0, :, 7] = 1
    return {"points": pts, "points_mask": np.ones((1, n), bool),
            "gt_boxes": gt}


def outcomes(model, ds, num_class, post=False, forward=True):
    """What each package does with MODEL `model` over the dataset `ds` on
    fake_batch: the JAX detector's init traced by jax.eval_shape (every
    module's setup and the eval forward, nothing computed), then with
    `post` its apply and post_process; the port's build, then (unless not
    `forward`) its eval forward and, with `post`, post_process. (JAX's
    exception or None, the port's exception or None)."""
    batch = fake_batch(ds)
    jdet = jax_build(JEDict(copy.deepcopy(dict(model))), num_class=num_class,
                     dataset=ds)
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "dropout", "sampling"))}

    def jax_side():
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        v = jdet.module.init(rngs, b, train=False)
        if post:
            jdet.post_process(jdet.module.apply(v, b, train=False))
        return v

    def torch_side():
        det = torch_build(copy.deepcopy(model), num_class, ds, device="cpu")
        if not forward:
            return
        with torch.no_grad():
            out = det({k: torch.from_numpy(v) for k, v in batch.items()})
            if post:
                det.post_process(out)

    got = []
    for side in (lambda: jax.eval_shape(jax_side), torch_side):
        try:
            side()
            got.append(None)
        except Exception as e:      # noqa: BLE001 — compared below
            got.append(e)
    return tuple(got)


def same_failure(jerr, terr):
    """Both packages raised a KeyError naming the same key."""
    assert isinstance(jerr, KeyError), repr(jerr)
    assert isinstance(terr, KeyError), repr(terr)
    assert jerr.args == terr.args, (jerr, terr)


@pytest.mark.parametrize("yaml,drop", [
    ("kitti_models/PartA2", "VFE"), ("kitti_models/PartA2", "DENSE_HEAD"),
    ("kitti_models/pv_rcnn", "VFE"), ("kitti_models/second", "DENSE_HEAD")])
def test_a_voxel_yaml_without_its_vfe_or_dense_head_is_refused(yaml, drop):
    """Neither package reads MODEL.NAME or requires a VFE or a dense head:
    both build these yamls without the key, and the forward fails where
    the reference's does, with its KeyError. Without a VFE nothing is
    voxelized and the voxel backbones find no ``voxel_features``; Part-A2
    without its dense head has no proposals for its ROI head
    (``batch_cls_preds``); SECOND without its dense head runs its forward
    and has nothing to post-process (``batch_cls_preds``, raised by
    post_process)."""
    cfg = cfg_from_yaml_file(f"tools/cfgs/{yaml}.yaml")
    model = copy.deepcopy(cfg.MODEL)
    del model[drop]
    jerr, terr = outcomes(model, yaml_dataset(cfg), len(cfg.CLASS_NAMES),
                          post=True)
    same_failure(jerr, terr)
    assert terr.args == (("voxel_features",) if drop == "VFE"
                         else ("batch_cls_preds",))


# MODEL's module keys and the registries of each package
MODULE_KEYS = ("VFE", "BACKBONE_3D", "MAP_TO_BEV", "BACKBONE_2D",
               "DENSE_HEAD", "PFE", "ROI_HEAD", "IMAGE_BACKBONE", "NECK",
               "VTRANSFORM", "FUSER")


def registries(pkg):
    """MODEL key -> the module NAMEs a package's registry holds (the port
    folds MeanVFE into its voxelizer and holds it in no registry)."""
    from importlib import import_module

    mods = {"VFE": ("vfe", "VFE_REGISTRY"),
            "BACKBONE_3D": ("backbones_3d", "BACKBONE_3D_REGISTRY"),
            "MAP_TO_BEV": ("backbones_2d", "MAP_TO_BEV_REGISTRY"),
            "BACKBONE_2D": ("backbones_2d", "BACKBONE_2D_REGISTRY"),
            "DENSE_HEAD": ("dense_heads", "DENSE_HEAD_REGISTRY"),
            "PFE": ("pfe", "PFE_REGISTRY"),
            "ROI_HEAD": ("roi_heads", "ROI_HEAD_REGISTRY"),
            "IMAGE_BACKBONE": ("backbones_image", "IMAGE_BACKBONE_REGISTRY"),
            "NECK": ("backbones_image", "NECK_REGISTRY"),
            "VTRANSFORM": ("view_transforms", "VTRANSFORM_REGISTRY"),
            "FUSER": ("backbones_2d.fuser", "FUSER_REGISTRY")}
    base = pkg.__name__.rsplit(".", 1)[0]
    out = {k: set(getattr(import_module(f"{base}.{m}"), r))
           for k, (m, r) in mods.items()}
    out["VFE"].add("MeanVFE")
    return out


def test_every_model_yaml_names_only_registered_modules():
    """The port refuses a yaml only where a module NAME is outside its
    registry (the registry's KeyError, as in the JAX package), and every
    model yaml under tools/cfgs/ names registered modules only, in both
    packages' registries, which hold the same names."""
    port, ref = registries(tdetectors), registries(jdetectors)
    assert port == ref
    refused = []
    for path in sorted(glob.glob("tools/cfgs/*_models/*.yaml")):
        if "seeker" in os.path.basename(path):
            continue
        model = cfg_from_yaml_file(path).MODEL
        if any(model[k]["NAME"] not in port[k]
               for k in MODULE_KEYS if k in model):
            refused.append(path[len("tools/cfgs/"):-len(".yaml")])
    assert tuple(refused) == tuple(sorted(REFUSED))
    for yaml in YAMLS + PORTED_SINCE:
        assert os.path.exists(f"tools/cfgs/{yaml}.yaml")
