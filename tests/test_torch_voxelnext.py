"""VoxelNeXt of the PyTorch port against the JAX package, on the narrow
model and small grid of tests/test_voxelnext_e2e.py (its DATA_CFG and
MODEL_CFG, here with the IoU branch, the rectifier and per-class NMS lists
of the Waymo yamls), the same numpy-seeded inputs and weights
(bench._random_variables through from_jax_variables): `bev_merge` (ids and
sums, three levels and four flipped copies), the backbone's sparse BEV
output and the head's predictions in the port's three windowed modes
(xla, pallas, posgather; on CPU tensors the kernels' plain versions) and
with the 5x5x5 downsamples of SPCONV_KERNEL_SIZES [5, 5, 3, 3], the head's
nearest-voxel assignment, its loss (focal, L1, IoU and DIoU terms) and its
decode (rectified per-class NMS; the double-flip merge), the whole
detector's loss and detections, and the six VoxelNeXt yamls built as
written with the JAX tree's leaves.

Tolerances: ids, coords, valid masks, assigned voxels, labels and counts
exact; bev_merge sums rtol 1e-6 (the same additions in the same order);
backbone features and head outputs rtol / atol 1e-4 in float32 (the JAX
side runs its exact XLA windowed convs at highest matmul precision, the
port sums the taps in another order); targets, heatmaps, boxes and scores
1e-5; losses rtol 1e-4. Decodes run on the same head outputs, the heatmap
logits rounded to 1/64 so that no two candidates' scores lie within float
rounding of each other.
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
from findnpropagate_torch.ops import sparse_ops as tso
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import cfg_from_yaml_file
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.ops import sparse_ops as jso
from tests.test_voxelnext_e2e import CLASS_NAMES, DATA_CFG, MODEL_CFG

TOL = dict(rtol=1e-5, atol=1e-5)
FWD = dict(rtol=1e-4, atol=1e-4)
B = 2


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def t(x):
    return torch.from_numpy(np.asarray(x))


def iou_cfg(model=None):
    """The e2e model with the IoU branch of the Waymo VoxelNeXt yamls."""
    m = copy.deepcopy(model or MODEL_CFG)
    h = m["DENSE_HEAD"]
    h["IOU_BRANCH"] = True
    h["SEPARATE_HEAD_CFG"]["HEAD_DICT"]["iou"] = {"out_channels": 1,
                                                  "num_conv": 2}
    h["RECTIFIER"] = [0.68, 0.71]
    h["POST_PROCESSING"]["NMS_CONFIG"].update({
        "NMS_THRESH": [0.8, 0.55], "NMS_PRE_MAXSIZE": [100, 60],
        "NMS_POST_MAXSIZE": [32, 20]})
    return m


def jax_forward(jdet, variables, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    keep = ("voxelnext_preds", "voxelnext_voxels", "encoded_sparse_bev",
            "sparse_window_overflow")
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, b: {k: x for k, x in jdet.apply(
            v, b, train=False).items() if k in keep})(variables, jb)
        loss, (tb, _) = jax.jit(jdet.loss)(variables, jb)
    return jax.tree.map(np.asarray, out), float(loss), {
        k: float(v) for k, v in tb.items()}


def jax_model(model):
    jcfg = copy.deepcopy(model)
    jcfg.BACKBONE_3D["SUBM_IMPL"] = "xla"
    jcfg.BACKBONE_3D["WINDOWED_PRECISION"] = "highest"
    return jcfg


@pytest.fixture(scope="module")
def setup():
    ds, _, _ = build_dataloader(copy.deepcopy(DATA_CFG), CLASS_NAMES,
                                batch_size=B, training=True, prefetch=0)
    batch = ds.collate_batch([ds[i] for i in range(B)])
    batch.pop("frame_id")
    batch.pop("batch_size")
    model = iou_cfg()
    jdet = jax_build(jax_model(model), num_class=2, dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, batch))
    out, loss, tb = jax_forward(jdet, variables, batch)
    tds = SyntheticDataset(EDict(copy.deepcopy(DATA_CFG)), CLASS_NAMES,
                           training=True)
    return dict(ds=ds, tds=tds, batch=batch, model=model, jdet=jdet,
                variables=variables, out=out, loss=loss, tb=tb)


def port(setup, mode="xla", model=None, variables=None):
    """The port's detector in SUBM_IMPL `mode`, with the JAX weights. The
    kernels' modes need blocks of a multiple of 512 ids (so does the
    reference's Pallas path), so there the backbone and the head take
    blocks of 512: with no window overflow the outputs do not depend on
    the block."""
    m = copy.deepcopy(model or setup["model"])
    m.BACKBONE_3D["SUBM_IMPL"] = mode
    if mode != "xla":
        for part in (m.BACKBONE_3D, m.DENSE_HEAD):
            part.update({"WINDOWED_BLOCK": 512, "WINDOWED_WINDOW": 2048})
    det = torch_build(m, num_class=2, dataset=setup["tds"], device="cpu")
    return from_jax_variables(variables or setup["variables"], det)


def forward(det, batch):
    with torch.no_grad():
        return det.eval()({k: t(v) for k, v in batch.items()})


def check_bev_and_preds(tout, out):
    assert int(out["sparse_window_overflow"]) == 0
    assert int(tout["sparse_window_overflow"]) == 0
    jb, tb = out["encoded_sparse_bev"], tout["encoded_sparse_bev"]
    for k in ("ids", "coords", "valid"):
        np.testing.assert_array_equal(tb[k].numpy(), jb[k], err_msg=k)
    assert jb["valid"].sum() > 0
    np.testing.assert_allclose(tb["features"].numpy(), jb["features"], **FWD)
    for jg, tg in zip(out["voxelnext_preds"], tout["voxelnext_preds"]):
        assert set(jg) == set(tg)
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), jg[k], err_msg=k,
                                       **FWD)


# ------------------------------------------------------------- bev_merge


@pytest.mark.parametrize("case", ["levels", "flips"])
def test_bev_merge_matches_jax(case):
    """Three levels at scales 1, 2, 4 (coinciding cells summed, cells out
    of the grid and invalid rows dropped, a capacity below the cells), and
    one list of four flipped copies (up to four rows a cell)."""
    rng = np.random.RandomState(0 if case == "levels" else 1)
    ny, nx = 24, 20
    spec = [(1, 400), (2, 150), (4, 60)] if case == "levels" else [(1, 900)]
    lists = []
    for s, n in spec:
        lim = 4 if case == "flips" else 1
        c = np.zeros((B, n, 3), np.int32)
        c[..., 1] = rng.randint(0, ny // s + lim, (B, n))
        c[..., 2] = rng.randint(0, nx // s + lim, (B, n))
        v = rng.rand(B, n) < 0.9
        if case == "levels":            # one row per cell within a level
            for i in range(B):
                _, first = np.unique(c[i, :, 1] * 1000 + c[i, :, 2],
                                     return_index=True)
                keep = np.zeros(n, bool)
                keep[first] = True
                v[i] &= keep
        f = rng.standard_normal((B, n, 6)).astype(np.float32)
        lists.append((c, v, f, s))
    cap = 300
    want = [jax.vmap(lambda *a: jso.bev_merge(
        list(a[0::3]), list(a[1::3]), list(a[2::3]),
        tuple(s for *_, s in lists), (ny, nx), cap))(
            *[x for c, v, f, _ in lists for x in (c, v, f)])][0]
    got = tso.bev_merge([t(c) for c, *_ in lists],
                        [t(v) for _, v, _, _ in lists],
                        [t(f) for _, _, f, _ in lists],
                        tuple(s for *_, s in lists), (ny, nx), cap)
    for name, w, g in zip(("ids", "coords", "valid"), want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert int(got[2].sum(1).min()) > 50
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- backbone + head


@pytest.mark.parametrize("mode", ["xla", "pallas", "posgather"])
def test_voxelnext_forward_matches_jax(setup, mode):
    """The sparse BEV list (ids, coords, valid equal; features 1e-4) and
    every group's head outputs, the port in each windowed mode against
    the JAX package's exact XLA windowed mode."""
    tout = forward(port(setup, mode), setup["batch"])
    check_bev_and_preds(tout, setup["out"])


def test_voxelnext_5x5x5_downsamples_match_jax(setup):
    """SPCONV_KERNEL_SIZES [5, 5, 3, 3] (the Waymo large yaml's 125-tap
    strided convs), the port in pallas mode (where K3 takes them in tap
    groups of five on the card) against JAX."""
    model = copy.deepcopy(setup["model"])
    model.BACKBONE_3D["SPCONV_KERNEL_SIZES"] = [5, 5, 3, 3]
    jdet = jax_build(jax_model(model), num_class=2, dataset=setup["ds"])
    variables = jax.tree.map(np.asarray, bench._random_variables(
        jdet, setup["batch"]))
    assert variables["params"]["backbone_3d"]["blocks2_down"][
        "kernel"].shape[0] == 125
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    with jax.default_matmul_precision("highest"):
        out = jax.tree.map(np.asarray, jax.jit(lambda v, b: {
            k: x for k, x in jdet.apply(v, b, train=False).items()
            if k in ("voxelnext_preds", "encoded_sparse_bev",
                     "sparse_window_overflow")})(variables, jb))
    tout = forward(port(setup, "pallas", model, variables), setup["batch"])
    check_bev_and_preds(tout, out)


def test_head_assignment_loss_and_decode_match_jax(setup):
    """On the JAX forward's voxels and head outputs: the nearest-voxel
    assignment of each group (heatmaps, targets, voxel indices, masks),
    the loss with the IoU branch (focal, L1, IoU L1 and DIoU terms) and
    the rectified per-class decode."""
    out, jdet = setup["out"], setup["jdet"]
    head = port(setup).dense_head
    tools = jdet.head_tools
    vox = out["voxelnext_voxels"]
    vox_xy = np.stack([vox["coords"][..., 2], vox["coords"][..., 1]],
                      -1).astype(np.float32)
    gt = setup["batch"]["gt_boxes"]
    assert int((gt[..., -1] > 0).sum()) > 4
    want = jax.jit(tools.assign)(jnp.asarray(gt), jnp.asarray(vox_xy),
                                 jnp.asarray(vox["valid"]))
    got = head.assign(t(gt), t(vox_xy), t(vox["valid"]))
    for name, w, g in zip(("heatmap", "targets", "inds", "masks"), want,
                          got):
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert np.asarray(want[3]).sum() > 4

    preds = tuple({k: t(v) for k, v in p.items()}
                  for p in out["voxelnext_preds"])
    tb_in = {"voxelnext_preds": preds,
             "voxelnext_voxels": {k: t(v) for k, v in vox.items()},
             "gt_boxes": t(gt)}
    jloss, jtb = jax.jit(tools.compute_loss)({
        "voxelnext_preds": out["voxelnext_preds"],
        "voxelnext_voxels": vox, "gt_boxes": jnp.asarray(gt)})
    loss, tb = head.compute_loss(tb_in)
    assert set(tb) == set(jtb) == {"hm_loss", "loc_loss", "rpn_loss",
                                   "iou_loss", "iou_reg_loss"}
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=1e-4,
                                   err_msg=k)
    check_decode(jax.jit(tools.get_bboxes), head.get_bboxes, out)


def quantized(preds):
    """The heatmap logits rounded to 1/64 (ties resolve by index on both
    sides; distinct scores stay far apart)."""
    return tuple({k: (np.round(v * 64) / 64).astype(np.float32)
                  if k == "hm" else v for k, v in p.items()} for p in preds)


def check_decode(jdecode, tdecode, out, min_count=1):
    q = quantized(out["voxelnext_preds"])
    vox = out["voxelnext_voxels"]
    jdets = jdecode({"voxelnext_preds": q, "voxelnext_voxels": vox})
    tdets = tdecode({"voxelnext_preds": tuple(
        {k: t(v) for k, v in p.items()} for p in q),
        "voxelnext_voxels": {k: t(v) for k, v in vox.items()}})
    np.testing.assert_array_equal(tdets.count.numpy(),
                                  np.asarray(jdets.count))
    assert int(tdets.count.min()) >= min_count
    np.testing.assert_array_equal(tdets.labels.numpy(),
                                  np.asarray(jdets.labels))
    np.testing.assert_allclose(tdets.boxes.numpy(), np.asarray(jdets.boxes),
                               **TOL)
    np.testing.assert_allclose(tdets.scores.numpy(),
                               np.asarray(jdets.scores), **TOL)
    return tdets


def test_double_flip_decode_matches_jax(setup):
    """DOUBLE_FLIP: four copies of each sample (original, y-, x-, xy-
    flipped), the flipped voxels and sign-sensitive channels turned back
    and coinciding cells averaged, then the decode; on seeded head outputs
    over seeded voxels of the stride-8 grid (batch 4 = 1 sample x 4)."""
    model = copy.deepcopy(MODEL_CFG)
    model["DENSE_HEAD"]["DOUBLE_FLIP"] = True
    model["DENSE_HEAD"]["SEPARATE_HEAD_CFG"]["HEAD_ORDER"].append("vel")
    model["DENSE_HEAD"]["SEPARATE_HEAD_CFG"]["HEAD_DICT"]["vel"] = {
        "out_channels": 2, "num_conv": 2}
    jdet = jax_build(jax_model(model), num_class=2, dataset=setup["ds"])
    head = torch_build(copy.deepcopy(model), num_class=2,
                       dataset=setup["tds"], device="cpu").dense_head
    rng = np.random.RandomState(3)
    b4, v, ny, nx = 4, 128, 16, 16
    coords = np.full((b4, v, 3), -1, np.int32)
    valid = np.zeros((b4, v), bool)
    for i in range(b4):
        cells = rng.choice(ny * nx, 100, replace=False)
        coords[i, :100, 0] = 0
        coords[i, :100, 1], coords[i, :100, 2] = cells // nx, cells % nx
        valid[i, :100] = True
    sizes = {"hm": 2, "center": 2, "center_z": 1, "dim": 3, "rot": 2,
             "vel": 2}
    preds = ({k: (rng.standard_normal((b4, v, n)) * (2.0 if k == "hm"
                                                     else 0.3)
                  ).astype(np.float32) for k, n in sizes.items()},)
    out = {"voxelnext_preds": preds,
           "voxelnext_voxels": {"coords": coords, "valid": valid}}
    tdets = check_decode(jax.jit(jdet.head_tools.get_bboxes),
                         head.get_bboxes, out)
    assert tdets.boxes.shape[0] == 1 and tdets.boxes.shape[-1] == 9


def test_voxelnext_detector_loss_and_detections_match_jax(setup):
    """The whole detector in training mode: loss and every tb entry
    (overflow included); and post_process on the JAX forward's outputs."""
    det = port(setup).train()
    loss, tb = det.loss({k: t(v) for k, v in setup["batch"].items()})
    assert set(tb) == set(setup["tb"])
    np.testing.assert_allclose(float(loss.detach()), setup["loss"],
                               rtol=1e-4)
    for k, v in setup["tb"].items():
        np.testing.assert_allclose(float(tb[k]), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    loss.backward()
    grads = flat(to_jax_tree(det, "grad"))
    assert np.abs(grads[("backbone_3d", "blocks6_down", "kernel")]).max() > 0
    check_decode(jax.jit(setup["jdet"].post_process), det.post_process,
                 setup["out"])


VOXELNEXT_YAMLS = [
    "tools/cfgs/nuscenes_models/cbgs_voxel0075_voxelnext.yaml",
    "tools/cfgs/nuscenes_models/voxelnext.yaml",
    "tools/cfgs/nuscenes_models/cbgs_voxel0075_voxelnext_doubleflip.yaml",
    "tools/cfgs/argo2_models/cbgs_voxel01_voxelnext.yaml",
    "tools/cfgs/waymo_models/voxelnext_ioubranch_large.yaml",
    "tools/cfgs/waymo_models/voxelnext2d_ioubranch.yaml",
]


@pytest.mark.parametrize("yaml", VOXELNEXT_YAMLS)
def test_voxelnext_yamls_build_as_written(yaml):
    """Each VoxelNeXt yaml builds through the port's build_network at full
    width as written (nothing run: the full grid is for the card); the
    Waymo large (5x5x5 downsamples, 256 channels) and 2D ones with the
    leaves and shapes of the JAX tree (the other four share their
    modules)."""
    cfg = cfg_from_yaml_file(yaml)
    voxel = next(p["VOXEL_SIZE"] for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p["NAME"] == "transform_points_to_voxels")
    data = bench_data_cfg(1, cfg, voxel=list(voxel))
    n_cls = len(cfg.CLASS_NAMES)
    ds = SyntheticDataset(EDict(data), cfg.CLASS_NAMES, training=False)
    det = torch_build(copy.deepcopy(cfg.MODEL), num_class=n_cls, dataset=ds,
                      device="cpu")
    assert det.backbone_3d.windowed and det.map_to_bev is None
    if "waymo" not in yaml:
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


def test_velocity_head_over_seven_value_boxes(setup):
    """The nuScenes yamls' velocity head over the data layer's 7-value
    boxes (where the reference's shapes do not broadcast): the velocity
    columns are left out of the L1, the other columns' loss is the one
    without the head."""
    out = setup["out"]
    head = port(setup).dense_head
    preds = tuple({k: t(v) for k, v in p.items()}
                  for p in out["voxelnext_preds"])
    vox = {k: t(v) for k, v in out["voxelnext_voxels"].items()}
    batch = {"voxelnext_preds": preds, "voxelnext_voxels": vox,
             "gt_boxes": t(setup["batch"]["gt_boxes"])}
    assert batch["gt_boxes"].shape[-1] == 8
    _, tb = head.compute_loss(batch)
    head.head_order = head.head_order + ["vel"]
    head.model_cfg = copy.deepcopy(head.model_cfg)
    head.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]["code_weights"] = [1.0] * 10
    batch["voxelnext_preds"] = tuple(
        dict(p, vel=torch.ones(p["hm"].shape[:2] + (2,))) for p in preds)
    _, tb_vel = head.compute_loss(batch)
    assert np.isfinite(float(tb_vel["loc_loss"]))
    np.testing.assert_allclose(float(tb_vel["loc_loss"]),
                               float(tb["loc_loss"]), rtol=1e-6)


def test_kernel_modes_need_blocks_of_512(setup):
    """The VoxelNeXt yamls' WINDOWED_BLOCK 640 in a kernels' mode: the
    reference's Pallas path asserts block % 512 == 0 and the port's
    wrappers raise the same way, so those modes run with the block
    overridden (tests/test_torch_voxelnext.py's `port`, chip_smoke.py
    phase 16)."""
    from findnpropagate_torch.ops import windowed_sparse as ws
    from findnpropagate_tpu.ops.pallas_sparse import windowed_conv_pallas

    ids = np.arange(0, 2 * 1280, 2, dtype=np.int32)
    feats = np.ones((1280, 8), np.float32)
    w = np.ones((27, 8, 8), np.float32)
    deltas = np.arange(-13, 14, dtype=np.int32)
    with pytest.raises(AssertionError, match="512"):
        windowed_conv_pallas(jnp.asarray(ids), jnp.asarray(feats),
                             jnp.asarray(ids), jnp.asarray(w),
                             jnp.asarray(deltas), block=640, window=1024,
                             interpret=True)
    with pytest.raises(ValueError, match="512"):
        ws.windowed_conv(t(ids)[None], t(feats)[None], t(ids)[None], t(w),
                         deltas, block=640, window=1024)
    model = copy.deepcopy(setup["model"])
    model.BACKBONE_3D.update({"SUBM_IMPL": "pallas", "WINDOWED_BLOCK": 640})
    det = torch_build(model, num_class=2, dataset=setup["tds"],
                      device="cpu")
    with pytest.raises(ValueError, match="512"):
        forward(det, setup["batch"])
