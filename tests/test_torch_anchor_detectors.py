"""PointPillar and SECOND of the PyTorch port against the JAX package, end
to end at small size (a few layers, narrow widths) on the same synthetic
batch and weights (the flax->torch weight bridge): the forward's head
outputs and decoded boxes, the detections, and the training loss with its
tb; the eval step and the loss of a detector without a sparse backbone
(no overflow to report: 0 from the eval step, no key in tb); and
`build_network` on the anchor and pillar yamls as written (full width,
nothing run), with the JAX tree's leaves and shapes, while every detector
that is not ported raises, naming item 15; and `init_random_` against
bench.py's `_random_variables` on both trees.

PointPillar is tests/test_pointpillar_e2e.py's model (PillarVFE, 32
channels, two BEV levels, AnchorHeadSingle on two classes); SECOND is
MeanVFE -> VoxelBackBone8x in gather mode (16 channels) ->
HeightCompression -> two BEV levels -> tools/cfgs/kitti_models/second.yaml's
head. Tolerances: head outputs and boxes 1e-4 (float32 convs summed in
another order through the BEV backbone and, for SECOND, the 16 sparse
convs, as tests/test_torch_centerpoint.py); the loss and its tb rtol 1e-4;
detections decoded by both packages from the same outputs with the class
logits rounded to 1/16 (untrained scores tie or nearly tie, and a near tie
may order differently on each side): counts and labels exact, boxes and
scores 1e-5.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from findnpropagate_torch.config import cfg_from_yaml_file
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.runtime.trainer import make_eval_step
from findnpropagate_torch.utils.weights import (
    from_jax_variables,
    init_random_,
    to_jax_tree,
)
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from test_pointpillar_e2e import CLASS_NAMES as PP_CLASSES
from test_pointpillar_e2e import DATA_CFG as PP_DATA
from test_pointpillar_e2e import MODEL_CFG as PP_MODEL

B = 2
KITTI = ("Car", "Pedestrian", "Cyclist")
SECOND_DATA = {
    "DATASET": "SyntheticDataset",
    "POINT_CLOUD_RANGE": [-12.8, -12.8, -5.0, 12.8, 12.8, 3.0],
    "SYNTHETIC": {"NUM_SCENES": B, "NUM_OBJECTS": 10,
                  "NUM_RAW_POINTS": 60000, "PATTERN": "lidar_ring"},
    "CAPACITIES": {"MAX_POINTS": 20000, "MAX_GT": 16, "MAX_VOXELS": 4096,
                   "MAX_POINTS_PER_VOXEL": 5},
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"]},
    "DATA_PROCESSOR": [
        {"NAME": "mask_points_and_boxes_outside_range",
         "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "shuffle_points",
         "SHUFFLE_ENABLED": {"train": False, "test": False}},
        {"NAME": "transform_points_to_voxels",
         "VOXEL_SIZE": [0.2, 0.2, 0.2]}],
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def second_model():
    m = cfg_from_yaml_file("tools/cfgs/kitti_models/second.yaml").MODEL
    m.BACKBONE_3D.update({
        "MAX_VOXELS": 4096, "LEVEL_CAPACITIES": [4096, 4096, 4096, 2048,
                                                 2048],
        "CHANNELS": [16, 16, 16, 16, 16], "OUT_CHANNELS": 16,
        "DENSE_FROM_LEVEL": 2, "DENSE_DTYPE": "f32"})
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                          "NUM_UPSAMPLE_FILTERS": [16, 16]})
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 300
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 40
    return m


MODELS = {
    "pointpillar": (PP_DATA, PP_MODEL, tuple(PP_CLASSES)),
    "second": (SECOND_DATA, None, KITTI),
}
OUT_KEYS = ("cls_preds", "box_preds", "dir_cls_preds", "batch_box_preds")


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=list(MODELS))
def detectors(request):
    data, model, classes = MODELS[request.param]
    model = copy.deepcopy(model) if model is not None else second_model()
    ds, _, _ = build_dataloader(JEDict(copy.deepcopy(data)), list(classes),
                                batch_size=B, training=True, prefetch=0)
    batch = ds.collate_batch([ds[i] for i in range(B)])
    batch.pop("frame_id")
    batch.pop("batch_size")
    jdet = jax_build(JEDict(copy.deepcopy(model)), num_class=len(classes),
                     dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet,
                                                                 batch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        out = jax.tree.map(np.asarray, {
            k: v for k, v in jdet.apply(variables, jb, train=False).items()
            if k in OUT_KEYS + ("batch_cls_preds",
                                "sparse_window_overflow")})
        loss, (ltb, _) = jdet.loss(variables, jb)
    tdet = torch_build(copy.deepcopy(model), num_class=len(classes),
                       dataset=ds, device="cpu")
    from_jax_variables(variables, tdet)
    return (request.param, batch, variables, out, jdet, float(loss),
            {k: float(v) for k, v in ltb.items()}, tdet)


def test_forward_and_loss_match_jax(detectors):
    name, batch, variables, out, jdet, jloss, jtb, tdet = detectors
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tout = tdet.eval()(dict(tb))
        tdets = tdet.post_process(tout)
    for k in OUT_KEYS:
        np.testing.assert_allclose(tout[k].numpy(), out[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert int(tdets.count.min()) > 0
    assert np.isfinite(tdets.boxes.numpy()).all()
    # the reference's gather mode adds no overflow; the port's gives 0 (a
    # trait of the reference kept in ROADMAP.md section 3)
    assert "sparse_window_overflow" not in out
    if name == "second":
        assert int(tout["sparse_window_overflow"]) == 0

    det = copy.deepcopy(tdet).train()
    loss, ttb = det.loss(dict(tb))
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    assert ("sparse_window_overflow" in ttb) == (name == "second")
    assert int(ttb.pop("sparse_window_overflow", 0)) == 0
    assert set(ttb) == set(jtb)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(ttb[k]), v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_detections_match_jax(detectors):
    """Both packages' post_process on the same forward outputs (logits
    rounded to 1/16), the yaml's NMS_CONFIG and SCORE_THRESH."""
    name, batch, variables, out, jdet, *_, tdet = detectors
    q = dict(out)
    q["batch_cls_preds"] = np.round(out["batch_cls_preds"] * 16) / 16
    want = jdet.post_process({k: jnp.asarray(v) for k, v in q.items()})
    got = tdet.post_process({k: torch.from_numpy(np.array(v))
                             for k, v in q.items()})
    assert int(got.count.min()) > 0
    for f in ("count", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5)


def test_eval_step_and_loss_without_a_sparse_backbone(detectors):
    """make_eval_step(with_overflow=True) gives 0 where no sparse backbone
    counts an overflow, as the reference's eval step does; the loss's tb
    then carries no overflow key."""
    name, batch, *_, tdet = detectors
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    dets, ovf = make_eval_step(tdet, with_overflow=True)(dict(tb))
    assert int(ovf) == 0 and ovf.ndim == 0
    assert int(dets.count.min()) > 0 and not tdet.training
    if name == "pointpillar":
        assert tdet.backbone_3d is None and ovf.dtype == torch.int32
        _, ttb = copy.deepcopy(tdet).train().loss(dict(tb))
        assert "sparse_window_overflow" not in ttb


def test_unread_keys_change_nothing_in_the_reference(detectors):
    """MULTI_CLASSES_NMS and OUTPUT_RAW_SCORE move neither package's
    detections (Detector3D.post_process always runs the class-agnostic
    post_process)."""
    name, batch, variables, out, jdet, *_, tdet = detectors
    q = {k: jnp.asarray(v) for k, v in out.items()}
    base = jdet.post_process(q)
    pc = copy.deepcopy(jdet.post_cfg)
    pc["NMS_CONFIG"]["MULTI_CLASSES_NMS"] = True
    pc["OUTPUT_RAW_SCORE"] = True
    flipped = copy.copy(jdet)
    flipped.post_cfg = pc
    other = flipped.post_process(q)
    for f in base._fields:
        np.testing.assert_array_equal(np.asarray(getattr(other, f)),
                                      np.asarray(getattr(base, f)))


def test_init_random_matches_bench(detectors):
    """init_random_ gives the port's PointPillar / SECOND the leaves
    bench.py's _random_variables gives the JAX tree (PFN layers, the
    anchor head's convs, the sparse backbone), in sorted-key order."""
    name, batch, variables, *_, tdet = detectors
    det = copy.deepcopy(tdet)
    init_random_(det, seed=0)
    for coll in ("params", "batch_stats"):
        got = flat(to_jax_tree(det, "param" if coll == "params" else coll))
        want = flat(variables[coll])
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg="/".join(k))


# ---------------------------------------------------------------- yamls

BUILDS = ("kitti_models/pointpillar", "kitti_models/second",
          "kitti_models/second_multihead",
          "lyft_models/cbgs_second_multihead",
          "lyft_models/cbgs_second-nores_multihead",
          "nuscenes_models/cbgs_pp_multihead",
          "nuscenes_models/centerpoint_pillar",
          "nuscenes_models/cbgs_dyn_pp_centerpoint",
          "waymo_models/pointpillar_1x", "waymo_models/second",
          "waymo_models/centerpoint_pillar_1x",
          "waymo_models/centerpoint_dyn_pillar_1x",
          "once_models/pointpillar", "once_models/second",
          "synthetic_models/pointpillar_synth")
LEAF_CHECKS = ("kitti_models/pointpillar", "kitti_models/second_multihead",
               "nuscenes_models/cbgs_dyn_pp_centerpoint")
NOT_PORTED = ("kitti_models/voxel_rcnn_car_focal_multimodal",
              "kitti_models/CaDDN", "nuscenes_models/bevfusion")


def yaml_dataset(cfg):
    """What build_network reads of a dataset, from the yaml's DATA_CONFIG
    as written."""
    dc = cfg.DATA_CONFIG
    pcr = np.asarray(dc.POINT_CLOUD_RANGE, np.float32)
    voxel = next(p["VOXEL_SIZE"] for p in dc.DATA_PROCESSOR
                 if p["NAME"] == "transform_points_to_voxels")
    caps = dc.get("CAPACITIES", {})
    return types.SimpleNamespace(
        class_names=list(cfg.CLASS_NAMES), point_cloud_range=pcr,
        voxel_size=list(voxel),
        grid_size=tuple(np.round((pcr[3:] - pcr[:3]) / np.asarray(
            voxel, np.float32)).astype(int)),
        num_point_features=len(dc.POINT_FEATURE_ENCODING.used_feature_list),
        max_voxels=int(caps.get("MAX_VOXELS", 1000)),
        max_points_per_voxel=int(caps.get("MAX_POINTS_PER_VOXEL", 5)))


@pytest.mark.parametrize("yaml", BUILDS)
def test_anchor_and_pillar_yamls_build_as_written(yaml):
    cfg = cfg_from_yaml_file(f"tools/cfgs/{yaml}.yaml")
    ds = yaml_dataset(cfg)
    det = torch_build(copy.deepcopy(cfg.MODEL), len(cfg.CLASS_NAMES), ds,
                      device="cpu")
    head = det.dense_head
    if hasattr(head, "tools"):
        s = int(cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]
                ["feature_map_stride"])
        assert head.tools.anchors.shape == (
            ds.grid_size[0] // s * (ds.grid_size[1] // s)
            * len(head.tools.class_slots), 7)
    if yaml not in LEAF_CHECKS:
        return
    jdet = jax_build(JEDict(copy.deepcopy(cfg.MODEL)), len(cfg.CLASS_NAMES),
                     ds)
    f = ds.num_point_features
    shapes = jax.eval_shape(lambda b: jdet.init(jax.random.PRNGKey(0), b), {
        "points": jax.ShapeDtypeStruct((1, 2048, f), jnp.float32),
        "points_mask": jax.ShapeDtypeStruct((1, 2048), jnp.bool_)})
    for coll in ("params", "batch_stats"):
        got = {k: v.shape for k, v in flat(to_jax_tree(
            det, "param" if coll == "params" else coll)).items()}
        want = {tuple(p.key for p in path): leaf.shape for path, leaf in
                jax.tree_util.tree_flatten_with_path(shapes[coll])[0]}
        assert got == want


@pytest.mark.parametrize("yaml", NOT_PORTED)
def test_other_detectors_still_raise(yaml):
    cfg = cfg_from_yaml_file(f"tools/cfgs/{yaml}.yaml")
    with pytest.raises(NotImplementedError, match="item 15"):
        torch_build(copy.deepcopy(cfg.MODEL), len(cfg.CLASS_NAMES),
                    yaml_dataset(cfg), device="cpu")
