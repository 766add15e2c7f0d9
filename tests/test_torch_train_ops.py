"""The training step's small parts of the PyTorch port, each against its
JAX counterpart on the same numpy inputs: the Hungarian solver, the rotated
BEV overlap, every loss function, the heatmap targets, the LR schedule and
optimizer updates (against optax), and the two BatchNorms in training mode.
Tolerances are float32 round-off (rtol 1e-5 .. 1e-4) unless stated.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from findnpropagate_torch.models import blocks as TB
from findnpropagate_torch.models.model_utils import centernet as TC
from findnpropagate_torch.ops import lap as TL
from findnpropagate_torch.ops import rotated_iou as TR
from findnpropagate_torch.runtime import optimization as TO
from findnpropagate_torch.utils import losses as TLo
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.models import blocks as JB
from findnpropagate_tpu.models.model_utils import centernet as JC
from findnpropagate_tpu.ops import lap as JL
from findnpropagate_tpu.ops import rotated_iou as JR
from findnpropagate_tpu.runtime import optimization as JO
from findnpropagate_tpu.utils import losses as JLo


def tt(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ solve_lap

@pytest.mark.parametrize("seed,n,m,n_valid", [
    (0, 12, 20, 12), (1, 16, 40, 9), (2, 8, 8, 8), (3, 16, 30, 0),
    (4, 1, 5, 1)])
def test_solve_lap_matches_jax_and_scipy(seed, n, m, n_valid):
    rng = np.random.RandomState(seed)
    cost = rng.standard_normal((n, m)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True     # padded rows anywhere
    got = TL.solve_lap(tt(cost), tt(valid)).numpy()
    want = np.asarray(JL.solve_lap(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (m,)
    rows = got[got >= 0]
    assert sorted(rows) == sorted(np.flatnonzero(valid))
    if n_valid:
        r, c = linear_sum_assignment(cost[valid])
        total = sum(cost[row, col] for col, row in enumerate(got)
                    if row >= 0)
        np.testing.assert_allclose(total, cost[valid][r, c].sum(), rtol=1e-5)


def test_solve_lap_batched_and_guarded():
    rng = np.random.RandomState(7)
    cost = rng.standard_normal((3, 6, 10)).astype(np.float32)
    valid = rng.uniform(size=(3, 6)) < 0.7
    got = TL.solve_lap(tt(cost), tt(valid)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], TL.solve_lap(tt(cost[b]), tt(valid[b])).numpy())
    with pytest.raises(ValueError, match="cannot all be matched"):
        TL.solve_lap(tt(cost[0].T.copy()), torch.ones(10, dtype=torch.bool))


# ------------------------------------------------------------- rotated overlap

def _boxes(rng, n, spread=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_boxes_overlap_bev_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 25)
    b[:5] = a[:5]                                    # identical pairs
    want = np.asarray(JR.boxes_overlap_bev(jnp.asarray(a), jnp.asarray(b)))
    got = TR.boxes_overlap_bev(tt(a), tt(b)).numpy()
    assert (want > 0.5).sum() > 20
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.diag(got)[:5], a[:5, 3] * a[:5, 4],
                               rtol=1e-3)
    # leading batch axes broadcast
    got2 = TR.boxes_overlap_bev(tt(np.stack([a, a])), tt(np.stack([b, b])))
    np.testing.assert_array_equal(got2[1].numpy(), got)
    np.testing.assert_allclose(
        TR.boxes_to_corners_bev(tt(a)).numpy(),
        np.asarray(JR.boxes_to_corners_bev(jnp.asarray(a))), atol=1e-5)


# ---------------------------------------------------------------------- losses

def _loss_inputs():
    rng = np.random.RandomState(1)
    logits = rng.standard_normal((2, 30, 5)).astype(np.float32) * 3
    onehot = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (2, 30))][..., :5]
    weights = rng.uniform(0, 2, (2, 30)).astype(np.float32)
    preds = rng.standard_normal((2, 30, 7)).astype(np.float32)
    tgts = rng.standard_normal((2, 30, 7)).astype(np.float32)
    tgts[0, 3, 2] = np.nan
    heat = rng.uniform(0, 1, (2, 5, 8, 8)).astype(np.float32)
    heat[:, :, 2, 3] = 1.0
    prob = rng.uniform(0.01, 0.99, (2, 5, 8, 8)).astype(np.float32)
    mask = rng.uniform(size=(2, 30)) < 0.5
    boxes = _boxes(rng, 12)
    return dict(logits=logits, onehot=onehot, weights=weights, preds=preds,
                tgts=tgts, heat=heat, prob=prob, mask=mask, boxes=boxes,
                boxes2=_boxes(rng, 12),
                cw=[1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.2])


LOSS_CASES = {
    "sigmoid_cross_entropy_with_logits": lambda d: (d["logits"], d["onehot"]),
    "sigmoid_focal_loss": lambda d: (d["logits"], d["onehot"], d["weights"]),
    "sigmoid_focal_loss_w3": lambda d: (
        d["logits"], d["onehot"], d["weights"][..., None] * d["onehot"]),
    "smooth_l1": lambda d: (d["preds"], 1.0 / 9.0),
    "smooth_l1_beta0": lambda d: (d["preds"], 0.0),
    "weighted_smooth_l1_loss": lambda d: (d["preds"], d["tgts"],
                                          d["weights"], 1.0 / 9.0, d["cw"]),
    "weighted_l1_loss": lambda d: (d["preds"], d["tgts"], d["weights"],
                                   d["cw"]),
    "l1_loss": lambda d: (d["preds"], d["preds"][::-1].copy()),
    "weighted_cross_entropy_loss": lambda d: (d["logits"], d["onehot"],
                                              d["weights"]),
    "gaussian_focal_loss": lambda d: (d["prob"], d["heat"]),
    "focal_loss_centernet": lambda d: (d["prob"], d["heat"]),
    "focal_loss_centernet_mask": lambda d: (d["prob"], d["heat"],
                                            d["heat"] > 0.3),
    "focal_loss_centernet_nopos": lambda d: (d["prob"], d["heat"] * 0.5),
    "reg_loss_centernet": lambda d: (d["preds"], d["tgts"], d["mask"]),
    "clip_sigmoid": lambda d: (d["logits"] * 4,),
    "corner_loss_lidar": lambda d: (d["boxes"], d["boxes2"]),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    args = LOSS_CASES[name](_loss_inputs())
    fn = name
    for suffix in ("_w3", "_beta0", "_mask", "_nopos"):
        fn = fn.removesuffix(suffix)

    def conv(a, f):
        return f(a) if isinstance(a, np.ndarray) else a

    want = np.asarray(getattr(JLo, fn)(*[conv(a, jnp.asarray)
                                         for a in args]))
    got = getattr(TLo, fn)(*[conv(a, tt) for a in args]).numpy()
    assert want.shape == got.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


# -------------------------------------------------------------------- heatmaps

def test_gaussian_radius_and_draw_heatmap_match_jax():
    rng = np.random.RandomState(2)
    m, c, h, w = 24, 4, 20, 28
    hw = rng.uniform(0.3, 9.0, (2, m)).astype(np.float32)
    for ov in (0.1, 0.5):
        np.testing.assert_allclose(
            TC.gaussian_radius(tt(hw[0]), tt(hw[1]), ov).numpy(),
            np.asarray(JC.gaussian_radius(jnp.asarray(hw[0]),
                                          jnp.asarray(hw[1]), ov)),
            rtol=1e-5)
    centers = rng.uniform(-2, 30, (m, 2)).astype(np.float32)
    radii = rng.randint(1, 6, m).astype(np.int32)
    cls = rng.randint(0, c, m).astype(np.int32)
    valid = rng.uniform(size=m) < 0.8
    want = np.asarray(JC.draw_heatmap(
        jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(cls),
        jnp.asarray(valid), num_classes=c, height=h, width=w))
    got = TC.draw_heatmap(tt(centers), tt(radii), tt(cls), tt(valid),
                          num_classes=c, height=h, width=w).numpy()
    assert (want == 1.0).sum() >= 5
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a leading batch axis, as the head calls it
    got2 = TC.draw_heatmap(tt(np.stack([centers, centers + 1])),
                           tt(np.stack([radii, radii])),
                           tt(np.stack([cls, cls])),
                           tt(np.stack([valid, ~valid])), c, h, w).numpy()
    np.testing.assert_array_equal(got2[0], got)
    assert got2.shape == (2, c, h, w)


# ------------------------------------------------------------------- optimizer

OPT_CFGS = {
    "adam_onecycle_wd": {"OPTIMIZER": "adam_onecycle", "LR": 1e-3,
                         "WEIGHT_DECAY": 0.01, "PCT_START": 0.4,
                         "DIV_FACTOR": 10, "GRAD_NORM_CLIP": 35},
    "adam_clipped": {"OPTIMIZER": "adam", "LR": 1e-4, "WEIGHT_DECAY": 0.0,
                     "GRAD_NORM_CLIP": 0.5},
    "adam_steps": {"OPTIMIZER": "adam", "LR": 1e-2,
                   "DECAY_STEP_LIST": [0.3, 0.5], "LR_DECAY": 0.1},
    "sgd": {"OPTIMIZER": "sgd", "LR": 1e-2, "MOMENTUM": 0.9,
            "GRAD_NORM_CLIP": 10.0},
}


@pytest.mark.parametrize("name", sorted(OPT_CFGS))
def test_lr_schedule_matches_optax(name):
    cfg = OPT_CFGS[name]
    want = JO.build_lr_schedule(JEDict(cfg), 50)
    got = TO.build_lr_schedule(cfg, 50)
    for step in list(range(0, 56)) + [200]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("name", sorted(OPT_CFGS))
def test_three_optimizer_steps_match_optax(name):
    """A toy two-leaf tree, three updates with fresh gradients each; the
    clip is active in `adam_clipped` (norm ~ 4 > 0.5)."""
    cfg = OPT_CFGS[name]
    rng = np.random.RandomState(3)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]

    tx, _ = JO.build_optimizer(JEDict(cfg), 10)
    params = jax.tree.map(jnp.asarray, p0)
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(tt(v.copy())) for k, v in p0.items()}
    ttx, sched = TO.build_optimizer(tparams.values(), cfg, 10)
    for i, g in enumerate(grads):
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
        for k, v in g.items():
            tparams[k].grad = tt(v.copy())
        norm = ttx.step()
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(g)), rtol=1e-5)
        for k in p0:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(params[k]),
                rtol=1e-5, atol=1e-7, err_msg=f"{k} after step {i}")
    assert ttx.count == 3
    with pytest.raises(KeyError):
        TO.build_optimizer(tparams.values(), {"OPTIMIZER": "lamb",
                                              "LR": 1.0}, 10)


# ------------------------------------------------------------------ BatchNorms

def test_masked_batchnorm_training_matches_jax():
    """Output, and the running mean / *biased* variance with momentum 0.99
    after two training calls; channels-last (sparse levels) and
    channels-first (dense levels) layouts."""
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 50, 6)).astype(np.float32) * 2 + 1
    valid = rng.uniform(size=(2, 50)) < 0.6
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    jbn = JB.MaskedBatchNorm(6)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    tbn = TB.MaskedBatchNorm(6).train()
    with torch.no_grad():
        tbn.scale.copy_(tt(scale))
        tbn.bias.copy_(tt(bias))
    for xi in (x, x * 0.5 - 1):
        want, mut = jbn.apply(variables, jnp.asarray(xi), jnp.asarray(valid),
                              True, mutable=["batch_stats"])
        variables = {"params": variables["params"], **mut}
        got = tbn(tt(xi), tt(valid), channels_last=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(tbn, leaf).numpy(),
            np.asarray(variables["batch_stats"][leaf]), rtol=1e-6)
    assert abs(float(tbn.var[0]) - 1.0) > 1e-3

    first = TB.MaskedBatchNorm(6).train()
    first.load_state_dict(TB.MaskedBatchNorm(6).state_dict())
    y_last = TB.MaskedBatchNorm(6).train()(tt(x), tt(valid),
                                           channels_last=True)
    y_first = first(tt(x).permute(0, 2, 1).reshape(2, 6, 5, 10),
                    tt(valid).reshape(2, 5, 10))
    np.testing.assert_allclose(
        y_first.reshape(2, 6, 50).permute(0, 2, 1).detach().numpy(),
        y_last.detach().numpy(), rtol=1e-6, atol=1e-6)
    # eval uses the stored statistics
    tbn.eval()
    want = jbn.apply(variables, jnp.asarray(x), jnp.asarray(valid), False)
    np.testing.assert_allclose(
        tbn(tt(x), tt(valid), channels_last=True).detach().numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims", [1, 2])
def test_batchnorm_training_stores_what_flax_stores(dims):
    rng = np.random.RandomState(5)
    shape = (3, 7, 4) if dims == 1 else (3, 5, 6, 4)     # channels last
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 2
    jbn = nn.BatchNorm(use_running_average=False, **JB.BN_KW)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, mut = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = (TB.BatchNorm1d if dims == 1 else TB.BatchNorm2d)(
        4, eps=TB.BN_EPS).train()
    xt = tt(x).movedim(-1, 1)
    got = tbn(xt).movedim(1, -1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5)
    # torch's own BatchNorm would store the unbiased variance at 0.1
    ref = torch.nn.BatchNorm1d(4).train()
    ref(xt.reshape(3, 4, -1))
    assert not np.allclose(ref.running_var.numpy(), tbn.running_var.numpy(),
                           rtol=1e-3)
    tbn.eval()
    want_eval = nn.BatchNorm(use_running_average=True, **JB.BN_KW).apply(
        {"params": variables["params"], **mut}, jnp.asarray(x))
    np.testing.assert_allclose(tbn(xt).movedim(1, -1).detach().numpy(),
                               np.asarray(want_eval), rtol=1e-4, atol=1e-5)
