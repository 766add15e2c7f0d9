"""The training slice as a whole — one TransFusion-LiDAR optimizer step —
of the PyTorch port against the JAX package, at the narrow widths of
tests/test_torch_transfusion.py on cropped lidar_ring scenes at batch 2,
12 objects per scene, dropout 0 on both sides (the two frameworks' random
bits differ), the same random weights.

The JAX side runs its exact XLA windowed sparse convs (SUBM_IMPL: xla) at
highest matmul precision; the port's posgather / windowed path equals them
whenever the overflow counter is 0, which is asserted.

Tolerances: loss and tb entries rtol 1e-4; assignment labels exact;
gradients per leaf within 2e-3 of the leaf's largest entry plus rtol 2e-3
(both f32, different summation orders through ~30 layers and three
batch-statistic BNs per block); BN statistics rtol 1e-4 / atol 1e-6;
parameters after one Adam step atol 2e-6 at lr 1e-4 (Adam's update is
~lr * sign(g), so a parameter moves by at most ~1e-4: 2e-6 is 2 % of the
move; the gradients themselves are held leaf by leaf above; entries
whose gradient is rounding noise, below 1e-8, are only held to within two
steps, and at most 40 entries may need that).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.runtime.optimization import (
    build_optimizer as torch_build_optimizer,
)
from findnpropagate_torch.runtime.trainer import (
    latest_checkpoint,
    latest_intra_checkpoint,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    save_intra_checkpoint,
    train_epochs,
)
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.runtime.optimization import build_optimizer
from test_torch_transfusion import DATA, narrow_cfg

B = 2
OPT = {"OPTIMIZER": "adam", "LR": 1e-4, "WEIGHT_DECAY": 0.0,
       "GRAD_NORM_CLIP": 10.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_data():
    data = copy.deepcopy(DATA)
    data["SYNTHETIC"]["NUM_OBJECTS"] = 12     # fewer than the 20 proposals
    return data


def train_cfg():
    cfg = narrow_cfg()
    cfg.MODEL.DENSE_HEAD["DROPOUT"] = 0.0
    return cfg


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def both():
    cfg = train_cfg()
    jcfg = copy.deepcopy(cfg.MODEL)
    jcfg.BACKBONE_3D["SUBM_IMPL"] = "xla"
    ds, _, _ = build_dataloader(JEDict(train_data()), cfg.CLASS_NAMES,
                                batch_size=B, training=True, prefetch=0)
    batch = ds.collate_batch([ds[i] for i in range(B)])
    batch.pop("frame_id")
    batch.pop("batch_size")
    jdet = jax_build(jcfg, num_class=10, dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, batch))

    tds = SyntheticDataset(EDict(train_data()), cfg.CLASS_NAMES,
                           training=True)
    tbatch = tds.batch(range(B))
    for k in ("points", "points_mask", "gt_boxes"):
        np.testing.assert_array_equal(tbatch[k], batch[k], err_msg=k)
    assert ((batch["gt_boxes"][..., -1] > 0).sum(axis=1) == 12).all()

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, batch_stats):
        loss, (tb, mut) = jdet.loss(
            {"params": params, "batch_stats": batch_stats}, jbatch,
            rng=jax.random.PRNGKey(0))
        return loss, (tb, mut["batch_stats"])

    def targets(params, batch_stats):
        out = jdet.module.apply(
            {"params": params, "batch_stats": batch_stats}, jbatch,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})[0]
        return jdet.head_tools.get_targets(out["transfusion_preds"],
                                           jbatch["gt_boxes"])

    with jax.default_matmul_precision("highest"):
        (loss, (tb, new_bs)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"], variables["batch_stats"])
        tgt = jax.jit(targets)(variables["params"], variables["batch_stats"])
    jref = {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
            "batch_stats": jax.tree.map(np.asarray, new_bs),
            "grads": jax.tree.map(np.asarray, grads),
            "targets": jax.tree.map(np.asarray, tgt)}

    tdet = torch_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=tds,
                       device="cpu")
    from_jax_variables(variables, tdet)
    tdet.train()
    tb_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jref, variables, tdet, tb_t


@pytest.fixture(scope="module")
def torch_loss(both):
    jref, variables, tdet, batch = both
    det = copy.deepcopy(tdet)
    loss, tb = det.loss(batch, torch.Generator().manual_seed(0))
    loss.backward()
    return det, float(loss.detach()), {k: float(v) for k, v in tb.items()}


def test_loss_and_tb_match_jax(both, torch_loss):
    jref = both[0]
    _, loss, tb = torch_loss
    assert tb["sparse_window_overflow"] == 0
    assert jref["tb"]["sparse_window_overflow"] == 0
    np.testing.assert_allclose(loss, jref["loss"], rtol=1e-4)
    assert set(tb) == set(jref["tb"])
    for k, v in jref["tb"].items():
        np.testing.assert_allclose(tb[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert sum(v for k, v in tb.items() if k.endswith("_matches")) == 24


def test_assignment_matches_jax(both):
    jref, _, tdet, batch = both
    det = copy.deepcopy(tdet)
    out = det(batch, torch.Generator().manual_seed(0))
    tgt = det.dense_head.get_targets(out["transfusion_preds"],
                                     batch["gt_boxes"])
    ref = jref["targets"]
    np.testing.assert_array_equal(tgt["labels"].numpy(), ref["labels"])
    np.testing.assert_array_equal(tgt["unknown_mask"].numpy(),
                                  ref["unknown_mask"])
    assert int(tgt["num_pos"]) == int(ref["num_pos"]) == 24
    for k in ("label_weights", "bbox_targets", "bbox_weights", "ious",
              "heatmap"):
        np.testing.assert_allclose(tgt[k].numpy(), ref[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_gradients_match_jax_leaf_by_leaf(both, torch_loss):
    jref = both[0]
    det = torch_loss[0]
    got = flat(to_jax_tree(det, "grad"))
    want = flat(jref["grads"])
    assert set(got) == set(want)
    for path, w in want.items():
        # leaves whose true gradient is zero (a bias ahead of a
        # batch-statistic BN) hold rounding noise of ~1e-9 on both sides
        atol = 2e-3 * max(float(np.abs(w).max()), 1e-5)
        np.testing.assert_allclose(got[path], w, rtol=2e-3, atol=atol,
                                   err_msg="/".join(path))
    assert sum(float(np.abs(w).max()) > 0 for w in want.values()) \
        > 0.9 * len(want)


def test_batch_stats_match_jax(both, torch_loss):
    jref = both[0]
    det = torch_loss[0]
    got = flat(to_jax_tree(det, "batch_stats"))
    want = flat(jref["batch_stats"])
    assert set(got) == set(want)
    moved = 0
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))
        start = 0.0 if path[-1] == "mean" else 1.0
        moved += bool(np.abs(w - start).max() > 1e-6)
    assert moved == len(want)


def test_one_train_step_matches_jax(both):
    """Parameters after one step of the port's make_train_step against
    optax's update of the JAX gradients (clip 10, adam, lr 1e-4)."""
    jref, variables, tdet, batch = both
    tx, _ = build_optimizer(JEDict(OPT), 1000)
    params = jax.tree.map(jnp.asarray, variables["params"])
    updates, _ = tx.update(jax.tree.map(jnp.asarray, jref["grads"]),
                           tx.init(params), params)
    want = flat(jax.tree.map(np.asarray,
                             optax.apply_updates(params, updates)))

    det = copy.deepcopy(tdet)
    ttx, _ = torch_build_optimizer(det.parameters(), OPT, 1000)
    metrics = make_train_step(det, ttx)(batch)
    assert ttx.count == 1
    np.testing.assert_allclose(float(metrics["loss"]), jref["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(
        float(metrics["grad_norm"]),
        float(optax.global_norm(jref["grads"])), rtol=1e-3)
    got = flat(to_jax_tree(det, "param"))
    start = flat(variables["params"])
    jgrads = flat(jref["grads"])
    n_off = 0
    for path, w in want.items():
        # an entry whose gradient is at rounding-noise level (|g| < 1e-8: a
        # true zero, as the whole of dense_head/decoder/norm3/bias here,
        # holds ~1e-9 of noise on both sides) is
        # normalised by Adam to a step of arbitrary size and sign: it is
        # only held to within two steps
        noise = np.abs(jgrads[path]) < 1e-8
        err = np.abs(got[path] - w)
        assert (err <= np.where(noise, 2.1e-4, 2e-6)).all(), \
            ("/".join(path), float(err.max()))
        n_off += int((err > 2e-6).sum())
    # 30 of the 209182 entries took the allowance when this was written
    assert n_off <= 40, n_off
    assert sum(np.abs(got[p] - start[p]).max() > 1e-5 for p in got) \
        > 0.9 * len(got)


class _Toy(torch.nn.Module):
    """BN-free toy detector: accumulation must equal the flat batch."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(16, 8)

    def loss(self, batch, generator=None):
        per = ((self.lin(batch["x"]) - batch["y"]) ** 2).mean(dim=-1)
        loss = per.mean()
        return loss, {"l2": loss.detach()}


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_matches_flat_batch_update(accum):
    rng = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rng.randn(8, 16).astype(np.float32)),
             "y": torch.from_numpy(rng.randn(8, 8).astype(np.float32))}
    torch.manual_seed(0)
    flat_det = _Toy()
    acc_det = copy.deepcopy(flat_det)
    opt = {"OPTIMIZER": "adam", "LR": 1e-2, "GRAD_NORM_CLIP": 1e9}
    tx1, _ = torch_build_optimizer(flat_det.parameters(), opt, 100)
    tx2, _ = torch_build_optimizer(acc_det.parameters(), opt, 100)
    m1 = make_train_step(flat_det, tx1)(batch)
    m2 = make_train_step(acc_det, tx2, accum_steps=accum)(batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["l2"]), float(m1["l2"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-4)
    for p1, p2 in zip(flat_det.parameters(), acc_det.parameters()):
        np.testing.assert_allclose(p2.detach().numpy(), p1.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_accum_chains_batch_stats(both):
    """accum_steps=2 over the batch of 2: each scene is a microbatch, the
    BN statistics move twice, and the metrics are the two losses' mean."""
    _, _, tdet, batch = both
    det = copy.deepcopy(tdet)
    chained = copy.deepcopy(tdet)
    singles = []
    for i in range(B):
        loss, _ = chained.loss({k: v[i:i + 1] for k, v in batch.items()},
                               torch.Generator().manual_seed(0))
        singles.append(float(loss))
    ttx, _ = torch_build_optimizer(det.parameters(), OPT, 1000)
    metrics = make_train_step(det, ttx, accum_steps=2)(batch)
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(singles),
                               rtol=1e-5)
    got = flat(to_jax_tree(det, "batch_stats"))
    want = flat(to_jax_tree(chained, "batch_stats"))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-7)


def test_checkpoint_round_trip(both, tmp_path):
    _, _, tdet, batch = both
    det = copy.deepcopy(tdet)
    ttx, _ = torch_build_optimizer(det.parameters(), OPT, 1000)
    step = make_train_step(det, ttx)
    step(batch)
    path = save_checkpoint(tmp_path, det, ttx)
    assert path.name == "checkpoint_1.pt"
    assert latest_checkpoint(tmp_path) == path
    save_intra_checkpoint(tmp_path, det, ttx, epoch=0, it=1)
    assert latest_intra_checkpoint(tmp_path)[1:] == (0, 1)

    other = copy.deepcopy(tdet)
    otx, _ = torch_build_optimizer(other.parameters(), OPT, 1000)
    assert restore_checkpoint(path, other, otx) == 1
    assert otx.count == 1
    for (k, a), (_, b) in zip(det.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    m1 = step(batch)
    m2 = make_train_step(other, otx)(batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for p1, p2 in zip(det.parameters(), other.parameters()):
        assert torch.equal(p1, p2)
    for i in range(2, 8):
        save_checkpoint(tmp_path, det, ttx, step=i)
    assert len(list(tmp_path.glob("checkpoint_*.pt"))) == 5
    assert latest_checkpoint(tmp_path).name == "checkpoint_7.pt"


def test_train_epochs_logs_and_warns(both, tmp_path):
    """The epoch loop over the port's DataLoader: history with step-time
    telemetry, a checkpoint per epoch, and the overflow warning."""
    from findnpropagate_torch.datasets import DataLoader

    cfg = train_cfg()
    data = train_data()
    data["SYNTHETIC"]["NUM_SCENES"] = 2
    ds = SyntheticDataset(EDict(data), cfg.CLASS_NAMES, training=True)
    det = copy.deepcopy(both[2])
    ttx, sched = torch_build_optimizer(det.parameters(), OPT, 10)
    lines = []

    class Log:
        info = staticmethod(lines.append)

    history = train_epochs(det, DataLoader(ds, 1), ttx, epochs=1,
                           logger=Log, ckpt_dir=tmp_path, log_interval=1,
                           schedule=sched)
    assert len(history) == 2 and ttx.count == 2
    assert all(np.isfinite(h["loss"]) and h["step_time"] > 0
               and h["sparse_window_overflow"] == 0 for h in history)
    assert latest_checkpoint(tmp_path).name == "checkpoint_1.pt"

    class Overflowing(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def loss(self, batch, generator=None):
            loss, tb = self.inner.loss(batch, generator)
            tb["sparse_window_overflow"] = torch.tensor(3)
            return loss, tb

    det2 = Overflowing(copy.deepcopy(both[2]))
    ttx2, _ = torch_build_optimizer(det2.parameters(), OPT, 10)
    with pytest.warns(RuntimeWarning, match="sparse_window_overflow=3"):
        train_epochs(det2, DataLoader(ds, 1), ttx2, epochs=1, logger=Log,
                     log_interval=1)


def test_pallas_mode_matches_posgather_mode(both):
    """SUBM_IMPL: pallas (every sparse conv through the union-window conv:
    fused epilogue at eval, the differentiable form in training) against
    the posgather mode on the same weights — f32 on the CPU, two summation
    orders: rtol/atol 1e-5 at eval, loss rtol 1e-5 and gradients as loose
    as against JAX in training."""
    _, _, tdet, batch = both
    cfg = train_cfg()
    pcfg = copy.deepcopy(cfg.MODEL)
    pcfg.BACKBONE_3D["SUBM_IMPL"] = "pallas"
    tds = SyntheticDataset(EDict(train_data()), cfg.CLASS_NAMES,
                           training=True)
    pdet = torch_build(pcfg, num_class=10, dataset=tds, device="cpu")
    pdet.load_state_dict(tdet.state_dict())
    ref_det = copy.deepcopy(tdet).eval()
    ref, out = ref_det(batch), pdet(batch)
    assert int(out["sparse_window_overflow"]) == 0
    assert not out["encoded_spconv_tensor"].requires_grad
    np.testing.assert_allclose(out["encoded_spconv_tensor"].numpy(),
                               ref["encoded_spconv_tensor"].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        out["transfusion_preds"]["heatmap"].numpy(),
        ref["transfusion_preds"]["heatmap"].numpy(), rtol=1e-5, atol=1e-5)

    ref_det.train()
    pdet.train()
    l_ref, _ = ref_det.loss(batch, torch.Generator().manual_seed(0))
    l_p, tb = pdet.loss(batch, torch.Generator().manual_seed(0))
    assert int(tb["sparse_window_overflow"]) == 0
    np.testing.assert_allclose(float(l_p.detach()), float(l_ref.detach()),
                               rtol=1e-5)
    l_ref.backward()
    l_p.backward()
    got, want = flat(to_jax_tree(pdet, "grad")), flat(to_jax_tree(ref_det,
                                                                  "grad"))
    for path, w in want.items():
        atol = 2e-3 * max(float(np.abs(w).max()), 1e-5)
        np.testing.assert_allclose(got[path], w, rtol=2e-3, atol=atol,
                                   err_msg="/".join(path))
