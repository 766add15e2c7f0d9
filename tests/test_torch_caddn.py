"""CaDDN of the PyTorch port against the JAX package, on the same
numpy-seeded inputs and flax weights (`from_jax_variables`; the BN
statistics off the identity):

  * `bin_depths` in its three modes, inside and outside each mode's
    domain, with the domain mask;
  * ImageVFE (the conv encoder, the depth softmax over num_bins + 1, the
    frustum and its trilinear sample at every voxel centre) at
    tests/test_caddn_e2e.py's widths on one camera looking along +x:
    eval, training, the gradient of every weight and the BN statistics
    (tests/test_torch_image_stack.py's harness);
  * `ddn_loss` on the same logits and points (the per-pixel nearest
    return's bin by scatter-min) and its gradient;
  * Conv2DCollapse: the (z, c) fold of the dense volume into channels;
  * CaDDN end to end at tests/test_caddn_e2e.py's size (its `slow` mark
    keeps it out of tier-1; its configs run here): the eval forward and
    the training loss with its tb.

Tolerances: bin indices 1e-5, the modules' outputs and BN statistics 1e-4
(float32 sums in another order), gradients 1e-3 of each leaf's largest
entry + 1e-6 of the largest over all leaves, the depth loss rtol 1e-5 and
its gradient 1e-5 of its scale, the detector's features 1e-4 and its loss
and tb rtol 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_caddn_e2e as jce
from findnpropagate_torch.models.backbones_2d import map_to_bev as tmb
from findnpropagate_torch.models.vfe import image_vfe as tiv
from findnpropagate_torch.utils.weights import from_jax_variables
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.models.backbones_2d import map_to_bev as jmb
from findnpropagate_tpu.models.vfe import image_vfe as jiv
from test_torch_image_stack import check_module, jax_module_run, nchw, t
from test_torch_roi_heads import random_like

TOL = 1e-4
GRID = (32, 32, 8)                      # nx, ny, nz
VOXEL = (0.4, 0.4, 0.5)
PCR = (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["LID", "UD", "SID"])
def test_bin_depths_matches_jax(mode):
    d = np.linspace(-3.0, 30.0, 67).astype(np.float32)
    got, ok = tiv.bin_depths(t(d), mode, 1.0, 20.0, 20, with_valid=True)
    want, wok = jiv.bin_depths(jnp.asarray(d), mode, 1.0, 20.0, 20,
                               with_valid=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    assert (~ok.numpy()).any() == (mode != "UD")


def camera(b):
    """KITTI-style transforms of a camera 0.1 m behind the grid looking
    along +x, and its principal point a little off the image's centre."""
    l2c = np.zeros((b, 4, 4), np.float32)
    l2c[:, :3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    l2c[:, :3, 3] = [0.013, 0.21, 6.5]
    l2c[:, 3, 3] = 1
    c2i = np.zeros((b, 3, 4), np.float32)
    c2i[:, :3, :3] = [[40.3, 0, 31.7], [0, 40.3, 24.2], [0, 0, 1]]
    return l2c, c2i


def vfe_batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    l2c, c2i = camera(b)
    pts = rng.uniform([-6, -6, -2.5, 0], [6, 6, 0.5, 1],
                      (b, 2000, 4)).astype(np.float32)
    return {"camera_imgs": rng.uniform(0, 1, (b, 1, 48, 64, 3)).astype(
                np.float32),
            "trans_lidar_to_cam": l2c, "trans_cam_to_img": c2i,
            "points": pts, "points_mask": rng.rand(b, 2000) > 0.1}


def vfe_cfg(mode="LID"):
    cfg = copy.deepcopy(jce.MODEL_CFG["VFE"])
    cfg["DISC_CFG"]["mode"] = mode
    return cfg


def jax_vfe(mode):
    return jiv.ImageVFE(model_cfg=JEDict(vfe_cfg(mode)), voxel_size=VOXEL,
                        point_cloud_range=PCR, grid_size=GRID)


def test_image_vfe_matches_jax():
    batch = vfe_batch()
    variables, res = jax_module_run(
        jax_vfe("LID"), batch, ["voxel_features_dense", "depth_logits"])
    vol = res["eval"]["voxel_features_dense"]
    assert vol.shape == (2, 8, 32, 32, 16)
    # most of the grid lies in the camera's view
    assert (np.abs(vol).sum(-1) > 0).mean() > 0.3
    check_module(tiv.ImageVFE(vfe_cfg("LID"), 4, VOXEL, PCR, GRID),
                 variables, res, {k: t(v) for k, v in batch.items()},
                 ["voxel_features_dense", "depth_logits"])


@pytest.mark.parametrize("mode", ["LID", "UD", "SID"])
def test_ddn_loss_matches_jax(mode):
    batch = vfe_batch(1)
    logits = np.random.RandomState(2).standard_normal(
        (2, 12, 16, 21)).astype(np.float32)
    cfg = vfe_cfg(mode)

    def jloss(lg):
        return jiv.ddn_loss({**batch, "depth_logits": lg}, cfg)[0]

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = t(np.moveaxis(logits, -1, 1)).requires_grad_(True)
    got, tb = tiv.ddn_loss({**{k: t(v) for k, v in batch.items()},
                            "depth_logits": lg}, cfg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(tb["depth_loss"].detach()) == float(got.detach()) > 0
    g = np.asarray(wgrad)
    np.testing.assert_allclose(nchw(lg.grad.numpy()), g, rtol=0,
                               atol=1e-5 * np.abs(g).max())


def test_conv2d_collapse_matches_jax():
    """The volume (B, nz, ny, nx, C) folds z into channels as z * C + c:
    the 1x1 conv's input channels in the reference's order."""
    vol = np.random.RandomState(3).standard_normal(
        (2, 4, 6, 5, 3)).astype(np.float32)
    cfg = {"NUM_BEV_FEATURES": 7}
    variables, res = jax_module_run(
        jmb.Conv2DCollapse(model_cfg=cfg, grid_size=(5, 6, 4)),
        {"voxel_features_dense": vol}, ["spatial_features"])
    check_module(tmb.Conv2DCollapse(cfg, (5, 6, 4), 3), variables, res,
                 {"voxel_features_dense": t(np.moveaxis(vol, -1, 1))},
                 ["spatial_features"])


# ------------------------------------------------------------------ CaDDN

_DET = {}


def caddn():
    """tests/test_caddn_e2e.py's detector and batch, random weights, and
    from one jit its eval features and training loss."""
    if _DET:
        return _DET
    from findnpropagate_tpu.datasets import build_dataloader
    from findnpropagate_tpu.models import build_network as jax_build

    ds, loader, _ = build_dataloader(copy.deepcopy(jce.DATA_CFG),
                                     ["Car", "Pedestrian"], batch_size=2,
                                     training=True)
    batch = next(iter(loader))
    batch.pop("frame_id")
    batch.pop("batch_size")
    det = jax_build(copy.deepcopy(jce.MODEL_CFG), num_class=2, dataset=ds)
    variables = random_like(jax.eval_shape(
        lambda: det.init(jax.random.PRNGKey(0), batch)), 4)
    keys = ("voxel_features_dense", "depth_logits", "spatial_features",
            "batch_cls_preds", "batch_box_preds")

    def run(v, bt):
        out = det.apply(v, bt, train=False)
        loss, (tb, _) = det.loss(v, bt)
        return {k: out[k] for k in keys}, loss, tb

    with jax.default_matmul_precision("highest"):
        res = jax.tree.map(np.asarray, jax.jit(run)(variables, batch))
    _DET.update(batch=batch, variables=variables, res=res, keys=keys)
    return _DET


def torch_caddn(variables):
    from findnpropagate_torch.config import EDict as TEDict
    from findnpropagate_torch.datasets.synthetic import SyntheticDataset
    from findnpropagate_torch.models import build_network as torch_build

    tds = SyntheticDataset(TEDict(copy.deepcopy(jce.DATA_CFG)),
                           ["Car", "Pedestrian"], training=True)
    det = torch_build(TEDict(copy.deepcopy(jce.MODEL_CFG)), 2, tds,
                      device="cpu")
    assert not det.voxelized and det.backbone_3d is None
    return from_jax_variables(variables, det)


def test_caddn_forward_matches_jax():
    d = caddn()
    det = torch_caddn(d["variables"]).eval()
    with torch.no_grad():
        out = det({k: t(v) for k, v in d["batch"].items()})
    for k in d["keys"]:
        got = out[k].numpy()
        if k in ("voxel_features_dense", "depth_logits", "spatial_features"):
            got = nchw(got)
        np.testing.assert_allclose(got, d["res"][0][k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert np.abs(d["res"][0]["voxel_features_dense"]).sum() > 0


def test_caddn_loss_matches_jax():
    d = caddn()
    det = torch_caddn(d["variables"]).train()
    loss, tb = det.loss({k: t(v) for k, v in d["batch"].items()})
    np.testing.assert_allclose(float(loss.detach()), float(d["res"][1]),
                               rtol=1e-4)
    assert "depth_loss" in tb
    for k, v in d["res"][2].items():
        np.testing.assert_allclose(float(torch.as_tensor(tb[k]).detach()),
                                   float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
