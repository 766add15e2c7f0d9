"""PillarNet and VoxelNeXt2D of the PyTorch port against the JAX package,
on the narrow models and small grids of tests/test_pillarnet_e2e.py and
tests/test_voxelnext2d_e2e.py (their DATA_CFG / MODEL_CFG and cfg_2d),
the same numpy-seeded inputs and weights (bench._random_variables through
from_jax_variables): PillarRes18BackBone8x and PillarBackBone8x (the dense
x_conv4 and the SAME-padded stride-16 x_conv5), BaseBEVBackboneV1, the
PillarNet detector's CenterHead outputs, loss and detections in the
port's windowed modes (xla, pallas, posgather; on CPU tensors the
kernels' plain versions), the VoxelNeXt2D backbone's sparse BEV list and
its detector's loss, and the three PillarNet yamls built as written.

Tolerances: ids, coords, valid masks, labels and counts exact; maps, head
outputs, boxes and scores rtol / atol 1e-4 in float32 (the JAX side runs
its exact XLA windowed convs at highest matmul precision; eight sparse and
ten dense convs in between); losses rtol 1e-4. Maps are compared in the
JAX package's NHWC layout.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.synthetic import (
    SyntheticDataset,
    bench_data_cfg,
)
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import cfg_from_yaml_file
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from tests.test_pillarnet_e2e import DATA_CFG, MODEL_CFG
from tests.test_torch_voxelnext import check_decode, flat, jax_model, t
from tests.test_voxelnext2d_e2e import cfg_2d

FWD = dict(rtol=1e-4, atol=1e-4)
CLASSES = ["Car", "Pedestrian"]
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_of(data):
    ds, _, _ = build_dataloader(copy.deepcopy(data), CLASSES, batch_size=B,
                                training=True, prefetch=0)
    batch = ds.collate_batch([ds[i] for i in range(B)])
    batch.pop("frame_id")
    batch.pop("batch_size")
    return ds, batch


def jax_run(jdet, variables, batch, keep):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fwd(v, b):
        out = {k: x for k, x in jdet.apply(v, b, train=False).items()
               if k in keep}
        if "multi_scale_2d_features" in out:      # the dense maps only
            out["multi_scale_2d_features"] = {
                k: out["multi_scale_2d_features"][k]
                for k in ("x_conv4_dense", "x_conv5")}
        return out

    with jax.default_matmul_precision("highest"):
        out = jax.jit(fwd)(variables, jb)
        loss, (tb, _) = jax.jit(jdet.loss)(variables, jb)
    return jax.tree.map(np.asarray, out), float(loss), {
        k: float(v) for k, v in tb.items()}


def port(data, model, variables, mode="xla"):
    m = copy.deepcopy(model)
    m.BACKBONE_3D["SUBM_IMPL"] = mode
    if mode != "xla":      # the kernels' modes take blocks of 512 ids
        m.BACKBONE_3D.update({"WINDOWED_BLOCK": 512,
                              "WINDOWED_WINDOW": 2048})
        if "WINDOWED_BLOCK" in m.DENSE_HEAD:
            m.DENSE_HEAD.update({"WINDOWED_BLOCK": 512,
                                 "WINDOWED_WINDOW": 2048})
    tds = SyntheticDataset(EDict(copy.deepcopy(data)), CLASSES,
                           training=True)
    det = torch_build(m, num_class=2, dataset=tds, device="cpu")
    return from_jax_variables(variables, det)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def check_loss(det, batch, jloss, jtb):
    loss, tb = det.train().loss({k: t(v) for k, v in batch.items()})
    assert set(tb) == set(jtb)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(tb[k]), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module", params=["PillarRes18BackBone8x",
                                        "PillarBackBone8x"])
def pillarnet(request):
    model = copy.deepcopy(MODEL_CFG)
    model.BACKBONE_3D["NAME"] = request.param
    ds, batch = batch_of(DATA_CFG)
    jdet = jax_build(jax_model(model), num_class=2, dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, batch))
    keep = ("multi_scale_2d_features", "spatial_features_2d", "center_preds",
            "sparse_window_overflow")
    out, loss, tb = jax_run(jdet, variables, batch, keep)
    return model, batch, jdet, variables, out, loss, tb


@pytest.mark.parametrize("mode", ["xla", "pallas", "posgather"])
def test_pillarnet_matches_jax(pillarnet, mode):
    """The dense stride-8 and stride-16 maps, BaseBEVBackboneV1's output,
    the CenterHead outputs and (xla mode) the loss and the detections."""
    model, batch, jdet, variables, out, loss, tb = pillarnet
    det = port(DATA_CFG, model, variables, mode)
    with torch.no_grad():
        tout = det.eval()({k: t(v) for k, v in batch.items()})
    assert int(out["sparse_window_overflow"]) == 0
    assert int(tout["sparse_window_overflow"]) == 0
    ms, tms = out["multi_scale_2d_features"], tout["multi_scale_2d_features"]
    for k in ("x_conv4_dense", "x_conv5"):
        assert np.abs(ms[k]).max() > 0
        np.testing.assert_allclose(nhwc(tms[k]), ms[k], err_msg=k, **FWD)
    np.testing.assert_allclose(nhwc(tout["spatial_features_2d"]),
                               out["spatial_features_2d"], **FWD)
    for jg, tg in zip(out["center_preds"], tout["center_preds"]):
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), jg[k], err_msg=k,
                                       **FWD)
    if mode == "xla":
        check_loss(det, batch, loss, tb)
        jd = jax.jit(jdet.post_process)({"center_preds": out["center_preds"]})
        td = det.post_process({"center_preds": tuple(
            {k: t(v) for k, v in g.items()} for g in out["center_preds"])})
        np.testing.assert_array_equal(td.count.numpy(), np.asarray(jd.count))
        np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes),
                                   **FWD)


@pytest.fixture(scope="module")
def voxelnext2d():
    data, model = cfg_2d()
    model["NAME"] = "VoxelNeXt"
    model["VFE"] = EDict({"NAME": "DynamicPillarVFESimple2D",
                          "WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True,
                          "USE_NORM": True, "NUM_FILTERS": [8]})
    ds, batch = batch_of(data)
    jdet = jax_build(jax_model(model), num_class=2, dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, batch))
    keep = ("encoded_sparse_bev", "voxelnext_preds", "voxelnext_voxels",
            "sparse_window_overflow")
    out, loss, tb = jax_run(jdet, variables, batch, keep)
    return data, model, batch, variables, out, loss, tb, jdet


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_voxelnext2d_matches_jax(voxelnext2d, mode):
    """The six sparse 2D stages, the BEV merge and the head: the sparse
    BEV list and the head's outputs, and (xla mode) the loss and the
    detections (decoded on the same head outputs)."""
    data, model, batch, variables, out, loss, tb, jdet = voxelnext2d
    det = port(data, model, variables, mode)
    with torch.no_grad():
        tout = det.eval()({k: t(v) for k, v in batch.items()})
    assert int(out["sparse_window_overflow"]) == 0
    assert int(tout["sparse_window_overflow"]) == 0
    jb, tb_ = out["encoded_sparse_bev"], tout["encoded_sparse_bev"]
    for k in ("ids", "coords", "valid"):
        np.testing.assert_array_equal(tb_[k].numpy(), jb[k], err_msg=k)
    np.testing.assert_allclose(tb_["features"].numpy(), jb["features"],
                               **FWD)
    for jg, tg in zip(out["voxelnext_preds"], tout["voxelnext_preds"]):
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), jg[k], err_msg=k,
                                       **FWD)
    if mode == "xla":
        check_loss(det, batch, loss, tb)
        check_decode(jax.jit(jdet.post_process), det.post_process, out)


PILLARNET_YAMLS = [
    "tools/cfgs/kitti_models/pillarnet.yaml",
    "tools/cfgs/waymo_models/pillarnet.yaml",
    "tools/cfgs/nuscenes_models/cbgs_pillar0075_res2d_centerpoint.yaml",
]


@pytest.mark.parametrize("yaml", PILLARNET_YAMLS)
def test_pillarnet_yamls_build_as_written(yaml):
    """The three PillarNet yamls build through the port's build_network at
    full width as written (nothing run); the nuScenes one with the leaves
    and shapes of the JAX tree (the others share its modules)."""
    cfg = cfg_from_yaml_file(yaml)
    voxel = next(p["VOXEL_SIZE"] for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p["NAME"] == "transform_points_to_voxels")
    n_cls = len(cfg.CLASS_NAMES)
    ds = SyntheticDataset(EDict(bench_data_cfg(1, cfg, voxel=list(voxel))),
                          cfg.CLASS_NAMES, training=False)
    det = torch_build(copy.deepcopy(cfg.MODEL), num_class=n_cls, dataset=ds,
                      device="cpu")
    assert det.backbone_2d.num_bev_features == 256
    if "nuscenes" not in yaml:
        return
    jdet = jax_build(copy.deepcopy(cfg.MODEL), num_class=n_cls, dataset=ds)
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
