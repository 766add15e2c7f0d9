"""The voxel two-stage detectors of the PyTorch port — SECONDNetIoU,
VoxelRCNN, PVRCNN and PVRCNNPlusPlus — against the JAX package end to end
at small size, on the same synthetic batch and weights (the flax->torch
weight bridge; init_random_ gives bench.py's _random_variables): the eval
forward (the ROIs, the second stage's scores and boxes, PV-RCNN's keypoint
features), the decoded detections, and the training loss with its tb,
the ROI sampling's draws handed to the port (the JAX heads' sampling key
pinned, as tests/test_torch_roi_heads.py does). Then every two-stage yaml
of tools/cfgs/ builds through the port's build_network at full width
(nothing run), while the yamls of later items still raise naming theirs.

The models and data are tests/test_{second_iou,voxelrcnn,pvrcnn,
pvrcnn_plusplus}_e2e.py's, whose `slow` mark keeps them out of tier-1:
SECOND-IoU on pillars (no sparse backbone), VoxelRCNN on VoxelBackBone8x
in the XLA windowed mode, PV-RCNN(++) on it in the gather mode, and
VoxelRCNN once more with the port in SUBM_IMPL posgather with blocks of
512 and windows of 2048 (on the CPU its K1-K4 wrappers run their plain
versions) against the
same JAX run in the XLA mode: both are exact float32 sparse convs, and a
windowed level's active voxels keep their sorted order whatever the
block. Both sides' window
overflow is asserted 0 on every scene (the reference is inexact
otherwise, ROADMAP.md section 3).

Both packages' first stage has its proposal scores (batch_cls_preds)
rounded to 1/16 (a hook on the dense head of each): untrained weights
leave most cells' scores equal but for their last bits, and the proposal
layer's order would follow those bits. Rounded, they tie exactly, and
both packages break ties by the lower index.

Tolerances: ROI labels, validity and detection counts exact; ROIs, head
outputs, keypoint features and boxes within 1e-4 (float32 convs summed in
another order through the sparse and BEV backbones, as
tests/test_torch_anchor_detectors.py); the loss and its tb rtol 1e-4;
detections decoded by both packages from the same outputs with the
second stage's logits rounded to 1/16 (untrained scores near-tie):
counts and labels exact, boxes and scores 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import flax
from findnpropagate_torch.config import cfg_from_yaml_file
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.utils.weights import (
    from_jax_variables,
    init_random_,
    to_jax_tree,
)
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.models.detectors.detector3d import RoIProposalStage
from findnpropagate_tpu.models.roi_heads import ROI_HEAD_REGISTRY
from test_pvrcnn_e2e import DATA_CFG as PV_DATA
from test_pvrcnn_e2e import MODEL_CFG as PV_MODEL
from test_pvrcnn_plusplus_e2e import MODEL_CFG as PVPP_MODEL
from test_second_iou_e2e import DATA_CFG as SI_DATA
from test_second_iou_e2e import MODEL_CFG as SI_MODEL
from test_torch_anchor_detectors import yaml_dataset
from test_voxelrcnn_e2e import DATA_CFG as VR_DATA
from test_voxelrcnn_e2e import MODEL_CFG as VR_MODEL

B = 2
KEY = jax.random.PRNGKey(11)
CLASSES = ("Car", "Pedestrian")


# label: (data, model, the port's SUBM_IMPL where it differs). The
# kernels' modes need blocks of 512 ids (ROADMAP.md section 3, PR 15 (a))
MODELS = {
    "second_iou": (SI_DATA, SI_MODEL, None),
    "voxelrcnn": (VR_DATA, VR_MODEL, None),
    "voxelrcnn_posgather": (VR_DATA, VR_MODEL, "posgather"),
    "pvrcnn": (PV_DATA, PV_MODEL, None),
    "pvrcnn_plusplus": (PV_DATA, PVPP_MODEL, None),
}
_JAX_RUNS = {}
OUT_KEYS = ("rois", "roi_labels", "roi_valid", "batch_cls_preds",
            "batch_box_preds", "batch_roi_labels", "point_coords",
            "point_valid", "point_features", "point_cls_scores",
            "sparse_window_overflow", "sparse_active_counts")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_round_stage1(next_fun, args, kwargs, context):
    """The JAX dense head's batch_cls_preds rounded to 1/16."""
    out = next_fun(*args, **kwargs)
    if context.module.name == "dense_head" \
            and context.method_name == "__call__" \
            and "batch_cls_preds" in out:
        r = jnp.round(out["batch_cls_preds"] * 16) / 16
        # -0.0 to +0.0: lax.top_k ranks -0.0 below +0.0
        out["batch_cls_preds"] = jnp.where(r == 0, 0.0, r)
    return out


def torch_round_stage1(module, inputs, out):
    """The port's dense head's batch_cls_preds rounded to 1/16."""
    if "batch_cls_preds" in out:
        r = torch.round(out["batch_cls_preds"] * 16) / 16
        out["batch_cls_preds"] = torch.where(r == 0, 0.0, r)
    return out


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def jax_run(data, model):
    """The JAX detector's batch, variables, eval outputs and loss (one run
    per model, shared by the port's modes)."""
    key = (id(data), id(model))
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    ds, _, _ = build_dataloader(JEDict(copy.deepcopy(data)), list(CLASSES),
                                batch_size=B, training=True, prefetch=0)
    batch = ds.collate_batch([ds[i] for i in range(B)])
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    jdet = jax_build(JEDict(copy.deepcopy(model)), num_class=len(CLASSES),
                     dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet,
                                                                 batch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def forward(v, b):
        out = jdet.apply(v, b, train=False)
        return {k: out[k] for k in OUT_KEYS if k in out}

    # the sampling key of every ROI stage pinned for the loss
    saved = {c: c.make_rng for c in (*ROI_HEAD_REGISTRY.values(),
                                     RoIProposalStage)}
    for c in saved:
        c.make_rng = lambda self, name: KEY
    try:
        with jax.default_matmul_precision("highest"), \
                flax.linen.intercept_methods(jax_round_stage1):
            out = jax.tree.map(np.asarray, jax.jit(forward)(variables, jb))
            loss, (ltb, _) = jax.jit(jdet.loss)(variables, jb)
    finally:
        for c, f in saved.items():
            c.make_rng = f
    _JAX_RUNS[key] = (ds, batch, variables, out, jdet, float(loss),
                      {k: float(v) for k, v in ltb.items()})
    return _JAX_RUNS[key]


@pytest.fixture(scope="module", params=list(MODELS))
def detectors(request):
    data, model, impl = MODELS[request.param]
    ds, batch, variables, out, jdet, loss, ltb = jax_run(data, model)
    tmodel = copy.deepcopy(model)
    if impl is not None:
        tmodel["BACKBONE_3D"].update(SUBM_IMPL=impl, WINDOWED_BLOCK=512,
                                     WINDOWED_WINDOW=2048)
    tdet = torch_build(tmodel, num_class=len(CLASSES), dataset=ds,
                       device="cpu")
    from_jax_variables(variables, tdet)
    tdet.dense_head.register_forward_hook(torch_round_stage1)
    m = int(model["ROI_HEAD"]["NMS_CONFIG"]["TRAIN"]["NMS_POST_MAXSIZE"])
    draws = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (m,)))(
        jax.random.split(KEY, B)))
    return (request.param, batch, variables, out, jdet, loss, ltb, tdet,
            draws)


def test_forward_matches_jax(detectors):
    name, batch, _, out, _, _, _, tdet, _ = detectors
    with torch.no_grad():
        tout = tdet.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(out.get("sparse_window_overflow", 0)) == 0
    if tdet.backbone_3d is not None:
        assert int(tout["sparse_window_overflow"]) == 0
        np.testing.assert_array_equal(tout["sparse_active_counts"].numpy(),
                                      out["sparse_active_counts"])
    for k in OUT_KEYS[:10]:
        if k not in out:
            continue
        got = tout[k].numpy()
        if out[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got, out[k], err_msg=k)
        else:
            np.testing.assert_allclose(got, out[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    assert int(tout["roi_valid"].sum()) > 0
    assert ("point_features" in tout) == name.startswith("pvrcnn")


def test_detections_match_jax(detectors):
    """Both packages' post_process on the same forward outputs (the
    second stage's logits rounded to 1/16): the two-stage path."""
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
    """The training loss with the reference's ROI draws: first stage, ROI
    head (and point head) terms, each tb entry."""
    _, batch, _, _, _, jloss, jtb, tdet, draws = detectors
    det = copy.deepcopy(tdet).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["roi_draws"] = torch.from_numpy(draws)
    loss, ttb = det.loss(tb)
    assert int(ttb.pop("sparse_window_overflow", 0)) == 0
    jtb = dict(jtb)
    assert int(jtb.pop("sparse_window_overflow", 0)) == 0
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    assert set(ttb) == set(jtb)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(ttb[k]), v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    loss.backward()
    grads = [p.grad for p in det.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    # the ROI losses reach the first stage's box regression through the
    # ROIs (the JAX package differentiates them)
    head = det.dense_head
    box = getattr(head, "conv_box", None)
    if box is not None:
        assert float(box.weight.grad.abs().sum()) > 0


def test_init_random_matches_bench(detectors):
    """init_random_ gives the port the leaves bench.py's
    _random_variables gives the JAX tree, PFE, point head and ROI head
    included, in sorted-key order."""
    _, _, variables, *_, tdet, _ = detectors
    det = copy.deepcopy(tdet)
    init_random_(det, seed=0)
    for coll in ("params", "batch_stats"):
        got = flat(to_jax_tree(det, "param" if coll == "params" else coll))
        want = flat(variables[coll])
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg="/".join(k))


# ---------------------------------------------------------------- yamls

TWO_STAGE_YAMLS = (
    "kitti_models/second_iou", "kitti_models/voxel_rcnn_car",
    "kitti_models/pv_rcnn", "custom_models/pv_rcnn", "once_models/pv_rcnn",
    "waymo_models/pv_rcnn", "waymo_models/pv_rcnn_plusplus",
    "waymo_models/pv_rcnn_plusplus_resnet",
    "waymo_models/pv_rcnn_plusplus_resnet_2frames",
    "waymo_models/pv_rcnn_with_centerhead_rpn",
    "waymo_models/voxel_rcnn_with_centerhead_dyn_voxel")
LATER = {"kitti_models/voxel_rcnn_car_focal_multimodal": "15.6",
         "kitti_models/CaDDN": "15.7", "waymo_models/mppnet_4frames": "15.8",
         "waymo_models/mppnet_e2e_memorybank_inference": "15.8"}


@pytest.mark.parametrize("yaml", TWO_STAGE_YAMLS)
def test_two_stage_yamls_build_as_written(yaml):
    cfg = cfg_from_yaml_file(f"tools/cfgs/{yaml}.yaml")
    det = torch_build(copy.deepcopy(cfg.MODEL), len(cfg.CLASS_NAMES),
                      yaml_dataset(cfg), device="cpu")
    m = cfg.MODEL
    assert det.roi_head is not None
    assert (det.pfe is not None) == ("PFE" in m)
    assert (det.point_head is not None) == ("POINT_HEAD" in m)
    assert (det.roi_proposal is not None) == bool(
        m.ROI_HEAD.get("PROPOSAL_BEFORE_PFE"))
    assert not det.training


@pytest.mark.parametrize("yaml", list(LATER))
def test_later_two_stage_yamls_raise_with_their_item(yaml):
    cfg = cfg_from_yaml_file(f"tools/cfgs/{yaml}.yaml")
    if not any(p["NAME"] == "transform_points_to_voxels"
               for p in cfg.DATA_CONFIG.DATA_PROCESSOR):
        # the point-based yamls voxelize nothing: any grid will do, the
        # detector's NAME is refused first
        cfg.DATA_CONFIG.DATA_PROCESSOR.append(
            {"NAME": "transform_points_to_voxels",
             "VOXEL_SIZE": [0.1, 0.1, 0.1]})
    with pytest.raises(NotImplementedError,
                       match=f"item {LATER[yaml].replace('.', '[.]')}"):
        torch_build(copy.deepcopy(cfg.MODEL), len(cfg.CLASS_NAMES),
                    yaml_dataset(cfg), device="cpu")


@pytest.mark.parametrize("head,item", [("MPPNetHead", "15.8"),
                                       ("MPPNetHeadE2E", "15.8")])
def test_later_roi_heads_raise_with_their_item(head, item):
    cfg = cfg_from_yaml_file("tools/cfgs/kitti_models/voxel_rcnn_car.yaml")
    m = copy.deepcopy(cfg.MODEL)
    m.ROI_HEAD.NAME = head
    with pytest.raises(NotImplementedError,
                       match=f"ROI_HEAD '{head}'.*item {item}"):
        torch_build(m, len(cfg.CLASS_NAMES), yaml_dataset(cfg),
                    device="cpu")


def test_two_stage_parts_need_a_two_stage_detector():
    """A PFE or ROI head under a one-stage detector's NAME is refused, as
    the reference builds no such topology in the port's registries."""
    cfg = cfg_from_yaml_file("tools/cfgs/kitti_models/pv_rcnn.yaml")
    m = copy.deepcopy(cfg.MODEL)
    m.NAME = "SECONDNet"
    with pytest.raises(NotImplementedError, match="item 15"):
        torch_build(m, len(cfg.CLASS_NAMES), yaml_dataset(cfg),
                    device="cpu")
