"""The focal backbone of the PyTorch port against the JAX package:

  * `sparse_ops.focal_dilate` bit for bit (ids, coords, validity and
    features) on two samples with the cut to `max_out` taking effect and
    not, an empty selection and invalid slots, and through the reference's
    own loop oracle (tests/test_focal_backbone.py, whose `slow` mark keeps
    it out of tier-1: its test body runs here as written, once on the JAX
    function and once with the port's swapped in);
  * `VoxelBackBone8xFocal` at tests/test_focal_backbone.py's size and
    config (MASK_MULTI, TOPK, blocks of 256) with DENSE_FROM_LEVEL 1 and 2
    (the dense branch: 26 rolls) and 99 (windowed levels only, with
    USE_IMG: images sampled at the voxel centres, and the same weights on
    a batch without images, zero planes): the eval levels, the training
    forward's ``loss_box_of_pts``, the gradient of every weight and the BN
    statistics;
  * the detector's focal loss (FocalTools): a narrow SECONDNet over the
    focal backbone on a synthetic batch, its loss and tb;
  * the launches of the importance and focal convs through the kernels'
    CUDA branches (a fake library that computes what the C entries
    compute): K3 only in pallas eval, K1 / K2 at the strided convs and K3
    at the rest in posgather eval, K3 (+ transposed) and K4 in training.

Weights come from the flax trees through `from_jax_variables` (random
leaves, the BN statistics off the identity). Tolerances: ids, coords,
validity, masks and overflow exact (the same foreground and dilation on
both sides: on these seeds no importance's float32 noise crosses the
TOPK cut or THRESHOLD); features 1e-4 (float32
sums in another order through up to 21 convs), the importance loss rtol
1e-5, gradients 1e-3 of each leaf's largest entry (training BN over few
actives), BN statistics 1e-4; the detector's loss and tb rtol 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_focal_backbone as jfb
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.models.backbones_3d import (
    spconv_backbone_focal as tfb,
)
from findnpropagate_torch.ops import posgather as TP
from findnpropagate_torch.ops import sparse_ops as tso
from findnpropagate_torch.ops import windowed_sparse as ws
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.models.backbones_3d import (
    spconv_backbone_focal as jfocal,
)
from findnpropagate_tpu.ops import sparse_ops as jso
from test_torch_roi_heads import flat, random_like

GRID = (32, 32, 40)
VOXEL = (0.4, 0.4, 0.1)
PCR = (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)
FEAT_TOL = 1e-4
GRAD_TOL = 1e-3
IMAGE = (48, 64)


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


# ------------------------------------------------------------ focal_dilate


def dilate_case(seed, n_active, max_out, p=0.1):
    """Two samples of jfb.make_level's actives (the second with fewer) and
    a random (V, 26) selection."""
    rng = np.random.RandomState(seed)
    levels = [jfb.make_level(rng, n_active=n, v_cap=128, c=4)
              for n in (n_active, n_active // 2)]
    ids, coords, valid, feats = (np.stack([lv[i] for lv in levels])
                                 for i in range(4))
    cand = rng.rand(2, 128, 26) < p
    return ids, valid, feats, cand, max_out


@pytest.mark.parametrize("case", ["fits", "cut", "empty", "dense"])
def test_focal_dilate_matches_jax(case):
    ids, valid, feats, cand, max_out = {
        "fits": lambda: dilate_case(0, 60, 384),
        "cut": lambda: dilate_case(1, 60, 96),
        "empty": lambda: dilate_case(2, 40, 128, p=0.0),
        "dense": lambda: dilate_case(3, 100, 512, p=0.6)}[case]()
    got = tso.focal_dilate(t(ids), t(feats), t(cand), jfb.SHAPE, max_out)
    for i in range(2):
        want = jso.focal_dilate(jnp.asarray(ids[i]), jnp.asarray(feats[i]),
                                jnp.asarray(cand[i]), jfb.SHAPE, max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    n = got[2].sum(1)
    if case == "cut":
        assert bool((n == max_out).any())
    if case == "empty":
        assert n.tolist() == valid.sum(1).tolist()


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_focal_dilate_loop_oracle(monkeypatch, impl):
    """The reference's loop-oracle test as written: every selected
    in-grid offset added once with zero features, the originals' features
    kept, ids ascending."""
    if impl == "port":
        def port(ids, feats, cand, shape, max_out):
            out = tso.focal_dilate(t(ids)[None], t(feats)[None],
                                   t(cand)[None], shape, max_out)
            return tuple(jnp.asarray(x[0].numpy()) for x in out)
        monkeypatch.setattr(jfb, "focal_dilate", port)
    jfb.test_focal_dilate_matches_loop_oracle()


# ------------------------------------------------------------ the backbone

# (DENSE_FROM_LEVEL, USE_IMG)
RUNS = {"dense1": (1, False), "dense2": (2, False), "windowed_img": (99, True)}
_JAX = {}


def images(seed, b):
    """Random RGB planes and a camera 0.1 m behind the grid looking along
    +x (KITTI's transforms): most voxel centres project into view."""
    rng = np.random.RandomState(seed)
    h, w = IMAGE
    l2c = np.zeros((b, 4, 4), np.float32)
    l2c[:, :3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    l2c[:, :3, 3] = [0.0, 0.0, 7.0]
    l2c[:, 3, 3] = 1
    c2i = np.zeros((b, 3, 4), np.float32)
    c2i[:, :3, :3] = [[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]]
    return {"images": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
            "trans_lidar_to_cam": l2c, "trans_cam_to_img": c2i}


def focal_cfg(run):
    dense_from, use_img = RUNS[run]
    cfg = jfb._focal_cfg(dense_from)
    cfg["USE_IMG"] = use_img
    return cfg


def pick(out):
    """The levels of a forward, its encoded map and telemetry as arrays."""
    res = {"encoded": out["encoded_spconv_tensor"],
           "ovf": out["sparse_window_overflow"]}
    if "loss_box_of_pts" in out:
        res["lbp"] = out["loss_box_of_pts"]
    for k, (kind, a, m) in out["multi_scale_3d_features"].items():
        if kind == "win":
            res.update({f"{k}_ids": a[0], f"{k}_valid": a[2],
                        f"{k}_feats": a[3]})
        else:
            res.update({f"{k}_x": a, f"{k}_mask": m})
    return res


def jax_focal(run):
    """Inputs, variables and, from one jit, the JAX backbone's eval levels
    (with USE_IMG also on the batch without images), its training
    outputs, the gradient of loss_box_of_pts + sum(sin(encoded)) and the
    updated BN statistics."""
    if run in _JAX:
        return _JAX[run]
    batch = {k: np.asarray(v) for k, v in
             jfb.make_batch(np.random.RandomState(1)).items()}
    if RUNS[run][1]:
        batch.update(images(2, 2))
    mod = jfocal.VoxelBackBone8xFocal(
        model_cfg=JEDict(focal_cfg(run)), input_channels=4, grid_size=GRID,
        voxel_size=VOXEL, point_cloud_range=PCR)
    variables = random_like(jax.eval_shape(
        lambda: mod.init(jax.random.PRNGKey(0), dict(batch), True)), 1)
    plain = {k: v for k, v in batch.items()
             if k not in ("images", "trans_lidar_to_cam",
                          "trans_cam_to_img")}

    def loss(params, rest, bt):
        out, mut = mod.apply({**rest, "params": params}, dict(bt), True,
                             mutable=["batch_stats"])
        total = out["loss_box_of_pts"] + jnp.sum(
            jnp.sin(out["encoded_spconv_tensor"]))
        return total, (pick(out), mut["batch_stats"])

    def both(v, bt, pl):
        rest = {k: x for k, x in v.items() if k != "params"}
        (_, (tr, stats)), grads = jax.value_and_grad(loss, has_aux=True)(
            v["params"], rest, bt)
        res = {"eval": pick(mod.apply(v, dict(bt), False)), "train": tr,
               "grads": grads, "stats": stats}
        if RUNS[run][1]:
            res["eval_no_images"] = pick(mod.apply(v, dict(pl), False))
        return res

    with jax.default_matmul_precision("highest"):
        res = jax.tree.map(np.asarray, jax.jit(both)(variables, batch, plain))
    _JAX[run] = (batch, plain, variables, res)
    return _JAX[run]


def torch_focal(run, variables, **extra):
    cfg = {**focal_cfg(run), **extra}
    mod = tfb.VoxelBackBone8xFocal(JEDict(cfg), 4, GRID, VOXEL, PCR)
    return from_jax_variables(variables, mod)


def torch_pick(out):
    return {k: v.detach().numpy() for k, v in pick(out).items()}


def same_outputs(got, want, tol=FEAT_TOL):
    for k, w in want.items():
        g = got[k]
        if k.endswith("_x") or k == "encoded":
            g = np.moveaxis(g, 1, -1)          # the port is channels first
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("run", list(RUNS))
def test_focal_backbone_forward_matches_jax(run):
    batch, plain, variables, res = jax_focal(run)
    mod = torch_focal(run, variables).eval()
    with torch.no_grad():
        got = torch_pick(mod({k: t(v) for k, v in batch.items()}))
    assert int(res["eval"]["ovf"]) == 0
    same_outputs(got, res["eval"])
    if RUNS[run][1]:
        with torch.no_grad():
            got = torch_pick(mod({k: t(v) for k, v in plain.items()}))
        same_outputs(got, res["eval_no_images"])
        # the image planes reach the importances, hence the dilation
        assert not np.array_equal(res["eval"]["x_conv1_valid"],
                                  res["eval_no_images"]["x_conv1_valid"])


@pytest.mark.parametrize("run", list(RUNS))
def test_focal_backbone_training_matches_jax(run):
    batch, _, variables, res = jax_focal(run)
    mod = torch_focal(run, variables).train()
    out = mod({k: t(v) for k, v in batch.items()})
    total = out["loss_box_of_pts"] + torch.sin(
        out["encoded_spconv_tensor"]).sum()
    total.backward()
    got = torch_pick(out)
    np.testing.assert_allclose(got.pop("lbp"), res["train"]["lbp"],
                               rtol=1e-5)
    want = dict(res["train"])
    want.pop("lbp")
    same_outputs(got, want)
    assert float(res["train"]["lbp"]) > 0
    counts = out["focal_active_counts"].numpy()
    assert (counts[:, 1] >= counts[:, 0]).all() and (counts[:, 0] > 0).all()
    g_t, g_j = flat(to_jax_tree(mod, "grad")), flat(res["grads"])
    assert set(g_t) == set(g_j)
    for k in g_j:
        scale = max(float(np.abs(g_j[k]).max()), 1e-6)
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=0,
                                   atol=GRAD_TOL * scale,
                                   err_msg="/".join(k))
    s_t, s_j = flat(to_jax_tree(mod, "batch_stats")), flat(res["stats"])
    assert set(s_t) == set(s_j)
    for k in s_j:
        np.testing.assert_allclose(s_t[k], s_j[k], rtol=1e-4, atol=1e-4,
                                   err_msg="/".join(k))


def test_fg_mask_keeps_ties_at_the_cut():
    """TOPK keeps every voxel at or above the k-th largest valid
    importance (ties included), k = max(int(n * THRESHOLD), 1), as the
    reference's masked quantile."""
    mod = tfb.VoxelBackBone8xFocal(JEDict(jfb._focal_cfg(99)), 4, GRID,
                                   VOXEL, PCR)
    mv = torch.tensor([[0.9, 0.7, 0.7, 0.1, 0.5, 0.2],
                       [0.3, 0.3, 0.3, 0.3, 0.0, 0.0]])
    valid = torch.tensor([[True] * 5 + [False], [True] * 4 + [False] * 2])
    got = mod._fg_mask(mv, valid)
    ref = jfocal.VoxelBackBone8xFocal(model_cfg=JEDict(jfb._focal_cfg(99)),
                                      input_channels=4, grid_size=GRID)
    for i in range(2):
        want = ref._fg_mask(jnp.asarray(mv[i].numpy()),
                            jnp.asarray(valid[i].numpy()))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert got.sum(1).tolist() == [3, 4]


def test_dense_levels_refuse_use_img():
    """The reference's dense branch fails on USE_IMG's widths; the port
    says why."""
    batch, _, variables, _ = jax_focal("dense1")
    cfg = {**jfb._focal_cfg(1), "USE_IMG": True}
    mod = tfb.VoxelBackBone8xFocal(JEDict(cfg), 4, GRID, VOXEL, PCR).eval()
    with pytest.raises(ValueError, match="USE_IMG"):
        with torch.no_grad():
            mod({k: t(v) for k, v in batch.items()})


# ------------------------------------------------------------ the detector

DATA = {
    "DATASET": "SyntheticDataset",
    "POINT_CLOUD_RANGE": [-12.8, -12.8, -5.0, 12.8, 12.8, 3.0],
    "SYNTHETIC": {"NUM_SCENES": 2, "NUM_OBJECTS": 6,
                  "NUM_RAW_POINTS": 6000},
    "CAPACITIES": {"MAX_POINTS": 6000, "MAX_GT": 8, "MAX_VOXELS": 1024,
                   "MAX_POINTS_PER_VOXEL": 5},
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"]},
    "DATA_PROCESSOR": [
        {"NAME": "mask_points_and_boxes_outside_range",
         "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "transform_points_to_voxels",
         "VOXEL_SIZE": [0.4, 0.4, 0.2]}],
}
CLASSES = ("Car", "Pedestrian")


def focal_detector_cfg():
    bb = {"NAME": "VoxelBackBone8xFocal", "CHANNELS": [8, 8, 16, 16, 16],
          "OUT_CHANNELS": 16, "SUBM_MODE": "windowed",
          "DENSE_FROM_LEVEL": 99, "WINDOWED_BLOCK": 256,
          "WINDOWED_WINDOW": 1024, "MAX_VOXELS": 1024, "THRESHOLD": 0.5}
    anchors = [{"class_name": n, "anchor_sizes": [s],
                "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.6],
                "align_center": False, "feature_map_stride": 8,
                "matched_threshold": 0.6, "unmatched_threshold": 0.45}
               for n, s in (("Car", [3.9, 1.6, 1.56]),
                            ("Pedestrian", [0.8, 0.6, 1.73]))]
    return {
        "NAME": "SECONDNet", "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": bb,
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 32},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1],
                        "LAYER_STRIDES": [1], "NUM_FILTERS": [16],
                        "UPSAMPLE_STRIDES": [1],
                        "NUM_UPSAMPLE_FILTERS": [16]},
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
            "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": anchors,
            "TARGET_ASSIGNER_CONFIG": {
                "NAME": "AxisAlignedTargetAssigner", "POS_FRACTION": -1.0,
                "SAMPLE_SIZE": 512, "NORM_BY_NUM_EXAMPLES": False,
                "MATCH_HEIGHT": False, "BOX_CODER": "ResidualCoder"},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
                "code_weights": [1.0] * 7}}},
        "POST_PROCESSING": {"RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
                            "SCORE_THRESH": 0.1,
                            "NMS_CONFIG": {"NMS_TYPE": "nms_gpu",
                                           "NMS_THRESH": 0.1,
                                           "NMS_PRE_MAXSIZE": 256,
                                           "NMS_POST_MAXSIZE": 64}},
    }


def test_detector_focal_loss_matches_jax():
    from findnpropagate_torch.config import EDict as TEDict
    from findnpropagate_torch.datasets.synthetic import SyntheticDataset
    from findnpropagate_tpu.datasets import build_dataloader
    from findnpropagate_tpu.models import build_network as jax_build

    jds, loader, _ = build_dataloader(JEDict(copy.deepcopy(DATA)),
                                      list(CLASSES), batch_size=2,
                                      training=True)
    batch = next(iter(loader))
    batch.pop("frame_id")
    batch.pop("batch_size")
    jdet = jax_build(JEDict(focal_detector_cfg()), 2, jds)
    variables = random_like(jax.eval_shape(
        lambda: jdet.init(jax.random.PRNGKey(0), batch)), 3)
    with jax.default_matmul_precision("highest"):
        loss_j, (tb_j, _) = jax.jit(jdet.loss)(variables, batch)
    assert "loss_box_of_pts" in tb_j
    tds = SyntheticDataset(TEDict(copy.deepcopy(DATA)), list(CLASSES),
                           training=True)
    tdet = torch_build(TEDict(focal_detector_cfg()), 2, tds, device="cpu")
    from_jax_variables(variables, tdet)
    tdet.train()
    loss_t, tb_t = tdet.loss({k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    for k, v in tb_j.items():
        if k == "sparse_window_overflow":
            assert int(tb_t[k]) == int(v) == 0
            continue
        np.testing.assert_allclose(float(torch.as_tensor(tb_t[k]).detach()),
                                   float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(tb_t["loss_box_of_pts"]) > 0


# ------------------------------------------------------- kernel dispatch


@pytest.mark.parametrize("mode,train,want", [
    ("pallas", False, {"positions": 0, "posgather_conv": 0,
                       "windowed_conv": 18, "windowed_dw": 0}),
    ("posgather", False, {"positions": 4, "posgather_conv": 4,
                          "windowed_conv": 14, "windowed_dw": 0}),
    ("pallas", True, {"positions": 0, "posgather_conv": 0,
                      "windowed_conv": 35, "windowed_dw": 18})])
def test_launches_per_mode(monkeypatch, mode, train, want):
    """Through the CUDA branches against a library that computes what the
    kernels compute (tests/test_torch_unet.py's FakeLib): per forward 11
    submanifold convs (the input conv, stage 1's, three focal convs and
    the stages' six) and 3 importance convs on K3, and 4 strided convs (on
    K1 / K2 at posgather eval, the (3, 1, 1) output conv as one tap group;
    else K3); in training each conv's K3 transposed (but the input conv's:
    voxel features need no gradient) and K4. The outputs equal the plain
    run's at the same bf16 operands within 3e-2 of their scale."""
    from test_torch_unet import FakeLib

    fake = FakeLib()
    batch, _, variables, res = jax_focal("windowed_img")
    kcfg = {"SUBM_IMPL": mode, "WINDOWED_BLOCK": 512,
            "WINDOWED_WINDOW": 2048}
    monkeypatch.setattr(ws, "_compute_dtype", lambda x: torch.bfloat16)
    ref = torch_focal("windowed_img", variables, **kcfg).train(train)
    with torch.set_grad_enabled(train):
        want_out = ref({k: t(v) for k, v in batch.items()})
    for m in (TP, ws):
        monkeypatch.setattr(m, "_check_device", lambda *a: True)
        monkeypatch.setattr(m, "_lib", lambda: fake)
        monkeypatch.setattr(m, "_stream", lambda: None)
        monkeypatch.setattr(m, "_ptr", lambda x: x)
    monkeypatch.setattr(TP, "_DELTAS", {})
    TP.reset_launches()
    ws.reset_launches()
    mod = torch_focal("windowed_img", variables, **kcfg).train(train)
    with torch.set_grad_enabled(train):
        out = mod({k: t(v) for k, v in batch.items()})
        if train:
            (out["loss_box_of_pts"]
             + out["encoded_spconv_tensor"].sum()).backward()
    got = {**TP.LAUNCHES, **ws.LAUNCHES}
    TP.reset_launches()
    ws.reset_launches()
    assert got == want
    enc, ref_enc = out["encoded_spconv_tensor"], want_out[
        "encoded_spconv_tensor"]
    scale = float(ref_enc.detach().abs().max())
    assert float((enc - ref_enc).abs().max()) <= 3e-2 * scale
    # the importance convs at Cin 8 + 3 and 16 + 3, padded to 16 and 32
    cins = {c[1] for c in fake.calls if c[0] == "conv"}
    assert {16, 32} <= cins
