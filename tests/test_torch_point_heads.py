"""The point-wise first-stage heads of the PyTorch port against the JAX
package on the same numpy-seeded points, boxes and weights (the
flax->torch weight bridge): PointHeadBox (PointRCNN; the reference's
binary head), PointIntraPartOffsetHead (Part-A2; with REG_FC as in
PartA2_free) and PointHeadBoxWPseudos (known-class ground truth relabelled
into the full class space plus pseudo boxes), each in eval and in
training mode (batch-statistic BN), with their targets
(`assign_point_targets`, binary and per class, `assign_part_targets`),
their losses and tb, and the losses' gradients into the head.

Points lie inside ground-truth boxes, in the GT_EXTRA_WIDTH ring around
them and outside; some are padding; one ground-truth row is padding.

Tolerances: labels exact; residual and part targets 1e-5; head outputs
1e-5 (1e-4 after training BN); decoded boxes 1e-4 (exp of the size
residuals); losses rtol 1e-5; gradients 1e-4 of each leaf's scale
(float32 sums over 300 points in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.models.dense_heads import point_head_box as tbox
from findnpropagate_torch.models.dense_heads import (
    point_intra_part_head as tpart,
)
from findnpropagate_torch.utils.box_coders import PointResidualCoder as TC
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict
from findnpropagate_tpu.models.dense_heads import point_head_box as jbox
from findnpropagate_tpu.models.dense_heads import (
    point_intra_part_head as jpart,
)
from findnpropagate_tpu.utils.box_coders import PointResidualCoder as JC
from test_torch_roi_heads import KEY, close, flat, random_like, same_stats, t

B, P, C = 2, 300, 12
MEAN = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
TARGET = {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2], "BOX_CODER": "PointResidualCoder",
          "BOX_CODER_CONFIG": {"use_mean_size": True, "mean_size": MEAN}}
LW = {"point_cls_weight": 1.0, "point_box_weight": 2.0,
      "point_part_weight": 1.5, "code_weights": [1.0] * 7 + [0.5]}


def scene(seed, g=5):
    """(points (B, P, 3), valid (B, P), ground truths (B, G, 8)): each box
    holds points, the 0.2 m ring around it some, the rest background."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, g, 8), np.float32)
    pts = rng.uniform(-12, 12, (B, P, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 1, (B, P))
    for b in range(B):
        for i in range(g - b):
            lab = 1 + i % 3
            gt[b, i, :3] = (rng.uniform(-9, 9), rng.uniform(-9, 9), -0.5)
            gt[b, i, 3:6] = MEAN[lab - 1]
            gt[b, i, 6] = rng.uniform(-np.pi, np.pi)
            gt[b, i, 7] = lab
            n = 30
            local = rng.uniform(-0.5, 0.5, (n, 3)) * gt[b, i, 3:6]
            local[-4:, 0] = np.sign(local[-4:, 0]) * (gt[b, i, 3] / 2 + 0.1)
            c, s = np.cos(gt[b, i, 6]), np.sin(gt[b, i, 6])
            world = np.stack([local[:, 0] * c - local[:, 1] * s,
                              local[:, 0] * s + local[:, 1] * c,
                              local[:, 2]], 1) + gt[b, i, :3]
            pts[b, i * n:(i + 1) * n] = world
    valid = np.ones((B, P), bool)
    valid[1, -20:] = False
    return pts, valid, gt


def head_inputs(seed, pseudo=False):
    pts, valid, gt = scene(seed)
    rng = np.random.RandomState(seed + 1)
    base = {"point_coords": pts, "point_valid": valid, "gt_boxes": gt,
            "point_features": rng.randn(B, P, C).astype(np.float32)}
    if pseudo:
        pb = np.zeros((B, 3, 8), np.float32)
        pb[:, 0] = [3, 3, -0.5, 0.8, 0.7, 1.7, 0.2, 5]      # class 5
        base["pseudo_boxes"] = pb
    return ({k: jnp.asarray(v) for k, v in base.items()},
            {k: t(v) for k, v in base.items()})


def head_cfg(**kw):
    return EDict({"CLS_FC": [16, 8], "REG_FC": [16], "PART_FC": [8],
                  "USE_POINT_FEATURES_BEFORE_FUSION": False,
                  "TARGET_CONFIG": TARGET,
                  "LOSS_CONFIG": {"LOSS_WEIGHTS": LW}, **kw})


def test_point_targets_match_jax():
    pts, valid, gt = scene(0)
    coder_j = JC(use_mean_size=True, mean_size=tuple(map(tuple, MEAN)))
    coder_t = TC(use_mean_size=True, mean_size=tuple(map(tuple, MEAN)))
    for binary in (True, False):
        jl, je = jbox.assign_point_targets(
            jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(gt), coder_j,
            (0.2, 0.2, 0.2), binary=binary)
        tl, te = tbox.assign_point_targets(t(pts), t(valid), t(gt), coder_t,
                                           (0.2, 0.2, 0.2), binary=binary)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        close(te, je)
        labels = tl.numpy()
        assert (labels == -1).any() and (labels == 0).any()
        assert set(np.unique(labels[labels > 0])) == (
            {1} if binary else {1, 2, 3})
    jl, jp = jpart.assign_part_targets(jnp.asarray(pts), jnp.asarray(valid),
                                       jnp.asarray(gt))
    tl, tp = tpart.assign_part_targets(t(pts), t(valid), t(gt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    close(tp, jp)
    fg = tl.numpy() > 0
    assert fg.any() and (tp.numpy()[fg] >= 0).all() \
        and (tp.numpy()[fg] <= 1).all()


HEADS = {
    "box": (jbox.PointHeadBox, tbox.PointHeadBox, {}, {}),
    "part": (jpart.PointIntraPartOffsetHead, tpart.PointIntraPartOffsetHead,
             {"num_class": 3}, {"num_class": 3}),
    "pseudos": (jbox.PointHeadBoxWPseudos, tbox.PointHeadBoxWPseudos,
                {"num_class": 6}, {"num_class": 6}),
}


OUT_KEYS = ("point_cls_preds", "point_cls_scores", "point_part_preds",
            "point_part_offset", "point_box_preds_enc", "batch_cls_preds",
            "batch_box_preds")


def losses(name, cfg, out, torch_side):
    mod = tbox if torch_side else jbox
    if name == "part":
        mod = tpart if torch_side else jpart
        return mod.point_part_head_loss(out, cfg, 3)
    if name == "pseudos":
        return mod.point_head_box_w_pseudo_loss(out, cfg)
    return mod.point_head_box_loss(out, cfg)


def jax_head(name, cfg, jb):
    """Random flax variables (BN statistics off the identity) and, in one
    jit, the JAX head's eval outputs and loss, its training outputs, loss,
    BN statistics and the loss's gradient into the parameters."""
    jcls, _, jkw, _ = HEADS[name]
    jm = jcls(model_cfg=cfg, input_channels=C, **jkw)
    variables = random_like(jax.eval_shape(
        lambda: jm.init({"params": KEY}, dict(jb), True)), 0)

    def pick(out):
        return {k: out[k] for k in OUT_KEYS if k in out}

    def run(v, batch):
        ev = jm.apply(v, dict(batch), False)

        def loss(params):
            out, mut = jm.apply({**v, "params": params}, dict(batch), True,
                                mutable=["batch_stats"])
            value, tb = losses(name, cfg, dict(out), False)
            return value, (pick(out), mut["batch_stats"], tb)

        (tl, (tr, stats, ttb)), grads = jax.value_and_grad(
            loss, has_aux=True)(v["params"])
        return (pick(ev), losses(name, cfg, dict(ev), False),
                tr, (tl, ttb), stats, grads)

    with jax.default_matmul_precision("highest"):
        out = jax.tree.map(np.asarray, jax.jit(run)(variables, jb))
    return variables, out


def same_losses(got, want):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(float(got[1][k]), float(want[1][k]),
                                   rtol=1e-5, err_msg=k)
    assert float(got[1]["point_pos_num"]) > 0


@pytest.mark.parametrize("name,reg", [("box", True), ("part", False),
                                      ("part", True), ("pseudos", True)])
def test_point_head_matches_jax(name, reg):
    """Eval and training forward, both losses with their tb, the BN
    statistics and the training loss's gradient into every parameter."""
    cfg = head_cfg()
    if name == "pseudos":
        cfg.ALL_CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Truck",
                               "Sign", "Cone"]
        cfg.KNOWN_CLASS_NAMES = ["Car", "Cyclist", "Pedestrian"]
    if not reg:
        del cfg["REG_FC"]
    jb, tb = head_inputs(3, pseudo=name == "pseudos")
    variables, (jev, jel, jtr, jtl, jstats, jgrads) = jax_head(name, cfg,
                                                               jb)
    _, tcls, _, tkw = HEADS[name]
    tm = tcls(cfg, C, **tkw)
    from_jax_variables(variables, tm)
    with torch.no_grad():
        tev = tm.eval()(dict(tb))
    ttr = tm.train()(dict(tb))
    keys = ["point_cls_preds", "point_cls_scores"]
    keys += ["point_part_preds", "point_part_offset"] if name == "part" \
        else []
    keys += ["point_box_preds_enc", "batch_cls_preds"] if reg else []
    for k in keys:
        close(tev[k], jev[k], msg=k)
        close(ttr[k].detach(), jtr[k], tol=1e-4, msg=k)
    if reg:
        close(tev["batch_box_preds"], jev["batch_box_preds"], tol=1e-4)
    else:
        assert "batch_box_preds" not in tev
    width = {"box": 1, "part": 3, "pseudos": 6}[name]
    assert tev["point_cls_preds"].shape == (B, P, width)
    same_stats(jstats, to_jax_tree(tm, "batch_stats"))
    with torch.no_grad():
        same_losses(losses(name, cfg, tev, True), jel)
    tloss = losses(name, cfg, ttr, True)
    same_losses((tloss[0].detach(), tloss[1]), jtl)
    tm.zero_grad()
    tloss[0].backward()
    got, want = flat(to_jax_tree(tm, "grad")), flat(jgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale,
                                   err_msg="/".join(k))


def test_pseudo_labels_relabel_known_classes():
    gt = np.zeros((1, 3, 8), np.float32)
    gt[0, :, 7] = [1, 3, 0]
    known, full = ["Car", "Cyclist", "Pedestrian"], ["Car", "Pedestrian",
                                                     "Cyclist", "Truck"]
    got = tbox.relabel_known_to_full(t(gt), known, full)
    want = jbox._relabel_known_to_full(jnp.asarray(gt), known, full)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, :, 7].tolist() == [1, 2, 0]
