"""BEVFusion's image stack of the PyTorch port against the JAX package, on
the same numpy-seeded inputs and flax weights (`from_jax_variables`; the
BN statistics off the identity):

  * `ops.bev_pool.bev_pool` and its gradient, also through the reference's
    naive-scatter oracle (tests/test_image_stack.py, whose `slow` mark
    keeps it out of tier-1: its test body runs here with the port's
    function swapped in);
  * SwinTransformer with shifted blocks, maps padded to the window and an
    odd map under PatchMerging; GeneralizedLSSFPN over three levels;
    DepthLSSTransform (its geometry, the lidar depth map, the lift and
    the splat, DOWNSAMPLE 2) on a rig of two tilted cameras; ConvFuser on
    equal grids and with the camera grid resized (bilinear, antialiased
    where it shrinks); ResNet18 and CLIPResNet — each in eval mode, in
    training mode (batch statistics), the gradient of sum(sin(outputs))
    for every weight and the updated BN statistics;
  * BEVFusion end to end at tests/test_image_stack.py's size (Swin + FPN +
    DepthLSS + ConvFuser over the windowed VoxelBackBone8x, CenterHead):
    the eval forward and the training loss with its tb.

The port's maps are NCHW where the reference's are NHWC; they are compared
after a transpose. Tolerances: bev_pool 1e-5 (float32 sums of the same
points in another order), the modules' outputs 1e-4 and BN statistics
1e-4 (float32 sums in another order through up to a dozen layers), their
gradients 1e-3 of each leaf's largest entry + 1e-6 of the largest over
all leaves (the zero gradients of a bias or a one-channel 1x1 conv before
a training BN are float32 noise; DepthLSS with its downsample: the
training output 2e-3 of its largest and the gradients + 5e-3, as the
downsample's BN over the splat's mostly empty cells divides by small batch
variances), the detector's head outputs
1e-4 and loss and tb rtol 1e-4. The frustum's cells (a floor of the
geometry) are asserted equal on both sides first, as a point on a cell's
edge would otherwise move by a rounding.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_image_stack as jis
from findnpropagate_torch.models.backbones_2d import fuser as tfu
from findnpropagate_torch.models.backbones_image import fpn as tfpn
from findnpropagate_torch.models.backbones_image import resnet as tres
from findnpropagate_torch.models.backbones_image import swin as tsw
from findnpropagate_torch.models.view_transforms import depth_lss as tlss
from findnpropagate_torch.ops import bev_pool as tbp
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.models.backbones_2d import fuser as jfu
from findnpropagate_tpu.models.backbones_image import fpn as jfpn
from findnpropagate_tpu.models.backbones_image import resnet as jres
from findnpropagate_tpu.models.backbones_image import swin as jsw
from findnpropagate_tpu.models.view_transforms import depth_lss as jlss
from findnpropagate_tpu.ops import bev_pool as jbp
from test_torch_roi_heads import flat, random_like

TOL = 1e-4
GRAD_TOL = 1e-3


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


def nchw(x):
    """A port map (B, C, ...) in the reference's channels-last layout."""
    return np.moveaxis(np.asarray(x), 1, -1)


# ------------------------------------------------------------ the harness


def jax_module_run(mod, batch, keys, seed=1):
    """variables and, from one jit, the module's eval outputs `keys`, its
    training outputs, the gradient of sum(sin(training outputs)) and the
    updated BN statistics."""
    variables = random_like(jax.eval_shape(
        lambda: mod.init(jax.random.PRNGKey(0), dict(batch), True)), seed)

    def pick(out):
        return {k: out[k] for k in keys}

    def loss(params, rest, bt):
        out, mut = mod.apply({**rest, "params": params}, dict(bt), True,
                             mutable=["batch_stats"])
        out = pick(out)
        return sum(jnp.sum(jnp.sin(x)) for x in jax.tree.leaves(out)), (
            out, mut.get("batch_stats", {}))

    def both(v, bt):
        rest = {k: x for k, x in v.items() if k != "params"}
        (_, (tr, stats)), grads = jax.value_and_grad(loss, has_aux=True)(
            v["params"], rest, bt)
        return {"eval": pick(mod.apply(v, dict(bt), False)), "train": tr,
                "grads": grads, "stats": stats}

    with jax.default_matmul_precision("highest"):
        res = jax.jit(both)(variables, batch)
    return variables, jax.tree.map(np.asarray, res)


def same(got, want, tol=TOL, msg=""):
    """Outputs (arrays or lists of them; the port's channels first)."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, tol, f"{msg}[{i}]")
        return
    np.testing.assert_allclose(nchw(got.detach().numpy()), want, rtol=tol,
                               atol=tol, err_msg=msg)
    assert np.isfinite(want).all()


def check_module(tmod, variables, res, batch, keys, tol=TOL,
                 train_scale_tol=None, grad_floor=1e-6):
    """The port module loaded with `variables` against the JAX run: eval,
    training outputs (within `train_scale_tol` of each output's largest
    entry where given), gradients (GRAD_TOL of each leaf's largest entry
    plus `grad_floor` of the largest over all leaves) and BN
    statistics."""
    from_jax_variables(variables, tmod)
    tmod.eval()
    with torch.no_grad():
        ev = tmod(dict(batch))
    for k in keys:
        same(ev[k], res["eval"][k], tol, f"eval {k}")
    tmod.train()
    tr = tmod(dict(batch))
    total = sum(torch.sin(x).sum() for k in keys for x in (
        tr[k] if isinstance(tr[k], list) else [tr[k]]))
    total.backward()
    for k in keys:
        tr_tol = tol if train_scale_tol is None else train_scale_tol * float(
            np.abs(res["train"][k]).max())
        same(tr[k], res["train"][k], tr_tol, f"train {k}")
    g_t, g_j = flat(to_jax_tree(tmod, "grad")), flat(res["grads"])
    assert set(g_t) == set(g_j)
    g_max = max(float(np.abs(g).max()) for g in g_j.values())
    for k in g_j:
        # the floor: a conv bias before a training BN, or a 1x1 conv of
        # one channel before one, has a zero gradient up to float32 noise
        scale = float(np.abs(g_j[k]).max())
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=0,
                                   atol=GRAD_TOL * scale + grad_floor * g_max,
                                   err_msg="/".join(k))
    s_t, s_j = flat(to_jax_tree(tmod, "batch_stats")), flat(res["stats"])
    assert set(s_t) == set(s_j)
    for k in s_j:
        np.testing.assert_allclose(s_t[k], s_j[k], rtol=tol, atol=tol,
                                   err_msg="/".join(k))


# ------------------------------------------------------------ bev_pool


def pool_case(seed):
    rng = np.random.RandomState(seed)
    n, c = 500, 8
    feats = rng.standard_normal((2, n, c)).astype(np.float32)
    coords = rng.randint(-2, 18, (2, n, 3)).astype(np.int32)
    valid = rng.rand(2, n) > 0.2
    return feats, coords, valid


def test_bev_pool_and_its_gradient_match_jax():
    feats, coords, valid = pool_case(0)
    nx, ny, nz = 16, 12, 4
    f = t(feats).requires_grad_(True)
    got = tbp.bev_pool(f, t(coords), t(valid), nx, ny, nz)
    r = np.random.RandomState(1).standard_normal(
        (2, ny, nx, nz * 8)).astype(np.float32)
    (got.permute(0, 2, 3, 1) * t(r)).sum().backward()
    for i in range(2):
        want = jbp.bev_pool(jnp.asarray(feats[i]), jnp.asarray(coords[i]),
                            jnp.asarray(valid[i]), nx, ny, nz)
        np.testing.assert_allclose(nchw(got[i:i + 1].detach())[0],
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        g = jax.grad(lambda x: jnp.sum(jbp.bev_pool(
            x, jnp.asarray(coords[i]), jnp.asarray(valid[i]), nx, ny, nz)
            * r[i]))(jnp.asarray(feats[i]))
        np.testing.assert_allclose(f.grad[i].numpy(), np.asarray(g),
                                   rtol=1e-6, atol=1e-6)


def test_bev_pool_naive_scatter_oracle(monkeypatch):
    def port(feats, coords, valid, nx, ny, nz):
        out = tbp.bev_pool(t(feats)[None], t(coords)[None], t(valid)[None],
                           nx, ny, nz)
        return jnp.asarray(nchw(out)[0])
    monkeypatch.setattr(jis, "bev_pool", port)
    jis.test_bev_pool_matches_naive_scatter()


# ------------------------------------------------------------ the modules

SWIN = {"EMBED_DIMS": 16, "DEPTHS": [2, 2], "NUM_HEADS": [2, 4],
        "WINDOW_SIZE": 4, "PATCH_SIZE": 4, "OUT_INDICES": [0, 1]}


def camera_imgs(seed, shape):
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_swin_matches_jax():
    """40 x 56 images: a 10 x 14 patch map padded to 12 x 16 for windows
    of 4, shifted by 2 in every second block; PatchMerging of an odd
    5 x 7 map; two cameras a sample."""
    batch = {"camera_imgs": camera_imgs(0, (1, 2, 40, 56, 3))}
    variables, res = jax_module_run(jsw.SwinTransformer(model_cfg=SWIN),
                                    batch, ["image_features"])
    assert [f.shape for f in res["eval"]["image_features"]] == [
        (2, 10, 14, 16), (2, 5, 7, 32)]
    check_module(tsw.SwinTransformer(SWIN), variables, res,
                 {"camera_imgs": t(batch["camera_imgs"])},
                 ["image_features"])


def test_swin_window_partition_and_mask_match_jax():
    x = np.random.RandomState(3).standard_normal((2, 8, 12, 5)).astype(
        np.float32)
    wins = tsw.window_partition(t(x), 4)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jsw.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tsw.window_reverse(wins, 4, 8, 12).numpy(),
                                  x)
    np.testing.assert_array_equal(tsw._rel_pos_index(7),
                                  jsw._rel_pos_index(7))
    mask = tsw._shift_mask(8, 12, 4, 2).numpy()
    assert mask.shape == (6, 16, 16) and set(np.unique(mask)) == {-100, 0}


def test_fpn_matches_jax():
    rng = np.random.RandomState(4)
    shapes = [(2, 16, 20, 8), (2, 8, 10, 16), (2, 4, 5, 32)]
    feats = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    variables, res = jax_module_run(
        jfpn.GeneralizedLSSFPN(model_cfg={"OUT_CHANNELS": 12}),
        {"image_features": feats}, ["image_fpn"])
    check_module(tfpn.GeneralizedLSSFPN({"OUT_CHANNELS": 12},
                                        in_channels=[8, 16, 32]),
                 variables, res,
                 {"image_features": [t(np.moveaxis(f, -1, 1))
                                     for f in feats]}, ["image_fpn"])


LSS = {"IN_CHANNEL": 8, "OUT_CHANNEL": 6, "IMAGE_SIZE": [64, 64],
       "FEATURE_SIZE": [8, 8], "XBOUND": [-12.8, 12.8, 0.8],
       "YBOUND": [-12.8, 12.8, 0.8], "ZBOUND": [-4, 4, 8.0],
       "DBOUND": [1.0, 13.0, 1.5], "DOWNSAMPLE": 2}


def rig(seed, b, ncam, hw=(64, 64)):
    """Per sample `ncam` cameras at yaws around the ring, each tilted and
    shifted a little (no frustum point on a cell edge), with their
    lidar2image, camera2lidar and intrinsics, and lidar points around."""
    rng = np.random.RandomState(seed)
    h, w = hw
    out = {k: np.zeros((b, ncam, 4, 4), np.float32)
           for k in ("lidar2image", "camera2lidar", "camera_intrinsics")}
    for i in range(b):
        for c in range(ncam):
            yaw = 2 * np.pi * c / ncam + rng.uniform(-0.2, 0.2)
            pitch = rng.uniform(-0.1, 0.1)
            rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                           [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
            ry = np.array([[np.cos(pitch), 0, np.sin(pitch)], [0, 1, 0],
                           [-np.sin(pitch), 0, np.cos(pitch)]])
            c2l = np.eye(4)
            c2l[:3, :3] = rz @ ry @ np.array([[0, 0, 1.0], [-1, 0, 0],
                                              [0, -1, 0]])
            c2l[:3, 3] = rng.uniform(-0.3, 0.3, 3)
            k = np.eye(4)
            k[:3, :3] = [[w * rng.uniform(0.9, 1.1), 0, w / 2 + 0.37],
                         [0, w * rng.uniform(0.9, 1.1), h / 2 - 0.21],
                         [0, 0, 1]]
            l2c = np.linalg.inv(c2l)
            out["camera2lidar"][i, c] = c2l
            out["camera_intrinsics"][i, c] = k
            out["lidar2image"][i, c] = k @ l2c
    pts = rng.uniform([-12, -12, -2, 0], [12, 12, 2, 1],
                      (b, 1500, 4)).astype(np.float32)
    out["points"] = pts
    out["points_mask"] = rng.rand(b, 1500) > 0.1
    return out


def lss_batch(seed=5, b=2, ncam=2):
    batch = rig(seed, b, ncam)
    batch["image_fpn"] = [np.random.RandomState(seed + 1).standard_normal(
        (b * ncam, 8, 8, 8)).astype(np.float32)]
    return batch


def test_depth_lss_geometry_and_cells_match_jax():
    batch = lss_batch()
    jm = jlss.DepthLSSTransform(model_cfg=LSS).bind({})
    tm = tlss.DepthLSSTransform(LSS)
    eye = np.eye(4, dtype=np.float32)
    got = tm.get_geometry(t(batch["camera2lidar"]),
                          t(batch["camera_intrinsics"]),
                          t(np.broadcast_to(eye, (2, 2, 4, 4))),
                          t(eye)[None, None]).numpy()
    lo = np.array([-12.8, -12.8, -4.0], np.float32)
    dx = np.array([0.8, 0.8, 8.0], np.float32)
    for i in range(2):
        for c in range(2):
            want = np.asarray(jm.get_geometry(
                jnp.asarray(batch["camera2lidar"][i, c]),
                jnp.asarray(batch["camera_intrinsics"][i, c]),
                jnp.eye(4), jnp.eye(4)))
            np.testing.assert_allclose(got[i, c], want, rtol=1e-5,
                                       atol=1e-4)
            np.testing.assert_array_equal(
                np.floor((got[i, c] - lo) / dx), np.floor((want - lo) / dx))
    depth = tm.rasterize_depth(t(batch["points"][..., :3]),
                               t(batch["points_mask"]),
                               t(batch["lidar2image"]),
                               t(np.broadcast_to(eye, (2, 2, 4, 4))),
                               t(np.broadcast_to(eye, (2, 4, 4)))).numpy()
    for i in range(2):
        want = np.asarray(jm.rasterize_depth(
            jnp.asarray(batch["points"][i, :, :3]),
            jnp.asarray(batch["points_mask"][i]),
            jnp.asarray(batch["lidar2image"][i]),
            jnp.broadcast_to(jnp.eye(4), (2, 4, 4)), jnp.eye(4)))
        np.testing.assert_allclose(depth[i], want[..., 0], rtol=1e-5,
                                   atol=1e-5)
        assert (want > 0).sum() > 20


@pytest.mark.parametrize("downsample", [1, 2])
def test_depth_lss_matches_jax(downsample):
    cfg = {**LSS, "DOWNSAMPLE": downsample}
    batch = lss_batch()
    variables, res = jax_module_run(jlss.DepthLSSTransform(model_cfg=cfg),
                                    batch, ["spatial_features_img"])
    assert res["eval"]["spatial_features_img"].shape == (
        (2, 16, 16, 6) if downsample == 2 else (2, 32, 32, 6))
    tb = {k: t(v) for k, v in batch.items() if k != "image_fpn"}
    tb["image_fpn"] = [t(np.moveaxis(batch["image_fpn"][0], -1, 1))]
    # with the downsample, training within 2e-3 of the output's scale and
    # the gradients 5e-3 of the largest: its BN normalises the splat's
    # mostly empty cells by small batch variances, which magnify the
    # float32 noise of the layers before it
    kw = {"train_scale_tol": 2e-3, "grad_floor": 5e-3} \
        if downsample > 1 else {}
    check_module(tlss.DepthLSSTransform(cfg), variables, res, tb,
                 ["spatial_features_img"], **kw)


@pytest.mark.parametrize("img_hw", [(10, 12), (20, 24), (5, 6)])
def test_conv_fuser_matches_jax(img_hw):
    """[lidar, image] on channels; the camera grid resized to the lidar's
    where they differ (shrunk: antialiased; grown)."""
    rng = np.random.RandomState(6)
    batch = {"spatial_features": rng.standard_normal(
        (2, 10, 12, 5)).astype(np.float32),
        "spatial_features_img": rng.standard_normal(
        (2,) + img_hw + (3,)).astype(np.float32)}
    cfg = {"OUT_CHANNEL": 7}
    variables, res = jax_module_run(jfu.ConvFuser(model_cfg=cfg), batch,
                                    ["spatial_features"])
    check_module(tfu.ConvFuser(cfg, in_channels=8), variables, res,
                 {k: t(np.moveaxis(v, -1, 1)) for k, v in batch.items()},
                 ["spatial_features"])


@pytest.mark.parametrize("name", ["ResNet18", "CLIPResNet"])
def test_resnets_match_jax(name):
    """ResNet18 (7x7 stride-2 stem, SAME max pool, projections) and a
    narrow CLIPResNet (LAYERS [1, 2], WIDTH 8: the average-pooled
    strides) on 36 x 44 images."""
    cfg = {"OUT_INDICES": [0, 1, 2, 3]} if name == "ResNet18" else {
        "LAYERS": [1, 2], "WIDTH": 8, "OUT_INDICES": [0, 1]}
    batch = {"camera_imgs": camera_imgs(7, (2, 1, 36, 44, 3))}
    variables, res = jax_module_run(getattr(jres, name)(model_cfg=cfg),
                                    batch, ["image_features"])
    check_module(getattr(tres, name)(cfg), variables, res,
                 {"camera_imgs": t(batch["camera_imgs"])},
                 ["image_features"])


# ------------------------------------------------------------ BEVFusion

_DET = {}


def bevfusion():
    """The JAX detector of tests/test_image_stack.py, its batch, weights,
    eval outputs and training loss, from one jit each."""
    if _DET:
        return _DET
    from findnpropagate_tpu.datasets import build_dataloader
    from findnpropagate_tpu.models import build_network as jax_build

    ds, loader, _ = build_dataloader(copy.deepcopy(jis.DATA_CFG),
                                     ["Car", "Pedestrian"], batch_size=2,
                                     training=True)
    batch = next(iter(loader))
    batch.pop("frame_id")
    batch.pop("batch_size")
    # the rig's cameras sit on the BEV cells' edges (a frustum point lands
    # exactly on one, and its cell follows the geometry's last bit): move
    # them by a few millimetres, the same batch for both packages
    batch["camera2lidar"][..., :3, 3] += np.float32([0.0137, -0.0071,
                                                     0.0033])
    det = jax_build(copy.deepcopy(jis.BEVFUSION_CFG), num_class=2,
                    dataset=ds)
    variables = random_like(jax.eval_shape(
        lambda: det.init(jax.random.PRNGKey(0), batch)), 2)
    keys = ("spatial_features_img", "spatial_features",
            "spatial_features_2d")

    def run(v, bt):
        out = det.apply(v, bt, train=False)
        loss, (tb, _) = det.loss(v, bt)
        return {k: out[k] for k in keys}, out["center_preds"], loss, tb

    with jax.default_matmul_precision("highest"):
        res = jax.tree.map(np.asarray, jax.jit(run)(variables, batch))
    _DET.update(batch=batch, variables=variables, res=res, keys=keys)
    return _DET


def torch_bevfusion(variables):
    from findnpropagate_torch.config import EDict as TEDict
    from findnpropagate_torch.datasets.synthetic import SyntheticDataset
    from findnpropagate_torch.models import build_network as torch_build

    tds = SyntheticDataset(TEDict(copy.deepcopy(jis.DATA_CFG)),
                           ["Car", "Pedestrian"], training=True)
    det = torch_build(TEDict(copy.deepcopy(jis.BEVFUSION_CFG)), 2, tds,
                      device="cpu")
    return from_jax_variables(variables, det)


def test_bevfusion_forward_matches_jax():
    d = bevfusion()
    det = torch_bevfusion(d["variables"]).eval()
    with torch.no_grad():
        out = det({k: t(v) for k, v in d["batch"].items()})
    feats, preds = d["res"][0], d["res"][1]
    for k in d["keys"]:
        same(out[k], feats[k], TOL, k)
    got = out["center_preds"]
    assert len(got) == len(preds)
    for g, w in zip(got, preds):       # channels last on both sides
        for name, arr in w.items():
            np.testing.assert_allclose(g[name].numpy(), arr, rtol=TOL,
                                       atol=TOL, err_msg=name)


def test_bevfusion_loss_matches_jax():
    d = bevfusion()
    det = torch_bevfusion(d["variables"]).train()
    loss, tb = det.loss({k: t(v) for k, v in d["batch"].items()})
    loss_j, tb_j = d["res"][2], d["res"][3]
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-4)
    for k, v in tb_j.items():
        np.testing.assert_allclose(float(torch.as_tensor(tb[k]).detach()),
                                   float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
