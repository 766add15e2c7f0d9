"""UNetV2 (Part-A2's sparse U-Net) and `win_inverse_conv` of the PyTorch
port against the JAX package on the same numpy-seeded voxels and weights:

  * `win_inverse_conv` against the JAX function and against
    tests/test_inverse_conv.py's dense-transpose oracle (every (coarse
    cell, tap) pair scattered by hand), two samples of different actives;
  * a narrow UNetV2 (CHANNELS [8, 16, 16, 16], OUT_CHANNEL 32, as
    tests/test_parta2_e2e.py) in the XLA windowed mode, eval forward and
    a training forward's gradient, at batch 1 and batch 3, overflow 0 on
    both sides;
  * the port's posgather and pallas modes (blocks of 512: on the CPU the
    K1-K4 wrappers run their plain versions) against the same JAX run;
  * the launches each mode makes through the kernels' CUDA branches,
    counted against a fake library that computes what the C entries
    compute (K1 the plain prelude and ranks, K2-K4 their plain products):
    posgather eval 4 K1 + 4 K2 (the three stage openers and conv_out, a
    single tap group) and 21 K3, pallas eval 25 K3, training K3 and K4
    and neither K1 nor K2; the inverse convs launch nothing.

The JAX package's own Pallas mode (its 25 windowed convs through the
Pallas interpreter, float32 operands by WINDOWED_PRECISION highest; about
12 s of jit on the CPU at batch 1) against the port's pallas mode, eval.

Tolerances: active sets, ids and overflow exact; features 1e-4 (float32
sums in another order through 25 convs); gradients 1e-3 of each leaf's
largest entry (training BN over few actives divides small variances);
the inverse conv 1e-5 against JAX and 1e-4 against the oracle (as
tests/test_inverse_conv.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.models.backbones_3d import spconv_unet as tun
from findnpropagate_torch.ops import posgather as TP
from findnpropagate_torch.ops import sparse_ops as tso
from findnpropagate_torch.ops import windowed_sparse as ws
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict
from findnpropagate_tpu.models.backbones_3d import spconv_unet as jun
from findnpropagate_tpu.ops import sparse_ops as jso
from test_torch_roi_heads import flat, random_like
from test_torch_windowed_sparse import _EmuLib, unpack_mma

GRID = (64, 64, 40)                   # nx, ny, nz
VOXEL = (0.2, 0.2, 0.1)
PCR = (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)
V = 512
CFG = {"NAME": "UNetV2", "CHANNELS": [8, 16, 16, 16], "OUT_CHANNEL": 32,
       "SUBM_MODE": "windowed", "WINDOWED_BLOCK": 128,
       "WINDOWED_WINDOW": 512, "MAX_VOXELS": V,
       # capacities that no level's actives reach, multiples of both
       # blocks: the modes then hold the same actives
       "LEVEL_CAPACITIES": [V, V, 2 * V, 512, 512]}
KERNEL_CFG = {"WINDOWED_BLOCK": 512, "WINDOWED_WINDOW": 2048}
FEAT_TOL = 1e-4
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


def voxels(seed, b):
    """(features (B, V, 4), zyx coords (B, V, 3), mask (B, V)): clusters of
    occupied cells inside the grid (objects and a ground band), some slots
    padding."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = GRID
    feats = np.zeros((b, V, 4), np.float32)
    coords = np.zeros((b, V, 3), np.int32)
    mask = np.zeros((b, V), bool)
    for i in range(b):
        cells = set()
        for _ in range(6):
            c = rng.randint([4, 4, 2], [nz - 4, ny - 4, nx - 4])
            ext = rng.randint([2, 3, 3], [6, 8, 8])
            for _ in range(V // 7):
                z, y, x = (int(v) for v in c + rng.randint(-ext, ext))
                if 0 <= z < nz and 0 <= y < ny and 0 <= x < nx:
                    cells.add((z, y, x))
        while len(cells) < (2 * V) // 3 + (V // 12) * i:
            cells.add((int(rng.randint(0, 3)), int(rng.randint(0, ny)),
                       int(rng.randint(0, nx))))
        cells = sorted(cells)[:V - 40]
        rng.shuffle(cells)
        n = len(cells)
        coords[i, :n] = cells
        mask[i, :n] = True
        feats[i, :n] = rng.randn(n, 4)
    return feats, coords, mask


# ------------------------------------------------------------ inverse conv


def inverse_case(seed):
    """A fine active list (sorted, padded) and the coarse list of the
    forward downsample rule, as tests/test_inverse_conv.py builds them."""
    rng = np.random.RandomState(seed)
    fine_shape, coarse_shape = (5, 16, 16), (3, 8, 8)
    nz, ny, nx = fine_shape
    lin = rng.choice(nz * ny * nx, 300 - 20 * seed, replace=False)
    coords = np.stack([lin % nz, (lin // nz) % ny, lin // (nz * ny)],
                      1).astype(np.int32)
    valid = np.ones(len(lin), bool)
    ids = np.asarray(jso.yxz_linear_ids(jnp.asarray(coords),
                                        jnp.asarray(valid), fine_shape))
    order = np.argsort(ids)
    ids, coords = ids[order], coords[order]
    pad = 320 - len(ids)
    f_ids = np.concatenate([ids, ids[-1] + 1 + np.arange(pad)]).astype(
        np.int32)
    f_coords = np.concatenate([coords, -np.ones((pad, 3), np.int32)])
    f_valid = np.concatenate([valid, np.zeros(pad, bool)])
    _, c_coords, c_valid = jso.win_downsample(
        jnp.asarray(f_coords), jnp.asarray(f_valid), fine_shape,
        coarse_shape, 256)
    c_feats = rng.standard_normal((256, 4)).astype(np.float32) \
        * np.asarray(c_valid)[:, None]
    return (f_ids, f_coords, f_valid, np.asarray(c_coords),
            np.asarray(c_valid), c_feats, fine_shape, coarse_shape)


def dense_transpose(f_coords, f_valid, c_coords, c_valid, c_feats, w):
    """For every (coarse c, tap t): fine cell 2c + t - 1 gets c's row @
    W_t (tests/test_inverse_conv.py's oracle)."""
    want = np.zeros((len(f_coords), w.shape[2]), np.float32)
    lut = {tuple(f_coords[i]): i for i in range(len(f_coords))
           if f_valid[i]}
    taps = [(tz, ty, tx) for tz in range(3) for ty in range(3)
            for tx in range(3)]
    for ci in np.flatnonzero(c_valid):
        for k, (tz, ty, tx) in enumerate(taps):
            fi = lut.get((2 * c_coords[ci][0] + tz - 1,
                          2 * c_coords[ci][1] + ty - 1,
                          2 * c_coords[ci][2] + tx - 1))
            if fi is not None:
                want[fi] += c_feats[ci] @ w[k]
    return want


def test_win_inverse_conv_matches_jax_and_the_dense_oracle():
    cases = [inverse_case(s) for s in (0, 1)]
    w = np.random.RandomState(7).standard_normal((27, 4, 6)).astype(
        np.float32) * 0.1
    fine_shape, coarse_shape = cases[0][6], cases[0][7]
    stack = [np.stack([c[i] for c in cases]) for i in range(6)]
    f_ids, f_coords, f_valid, c_coords, c_valid, c_feats = stack
    got, ovf = tso.win_inverse_conv(
        t(c_coords), t(c_valid), t(c_feats), t(f_ids), t(f_valid),
        fine_shape, coarse_shape, t(w), block=64, window=256)
    assert ovf.tolist() == [0, 0]
    for i in range(2):
        want, jovf = jso.win_inverse_conv(
            jnp.asarray(c_coords[i]), jnp.asarray(c_valid[i]),
            jnp.asarray(c_feats[i]), jnp.asarray(f_ids[i]),
            jnp.asarray(f_valid[i]), fine_shape, coarse_shape,
            jnp.asarray(w), block=64, window=256,
            precision=jax.lax.Precision.HIGHEST)
        assert int(jovf) == 0
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        oracle = dense_transpose(f_coords[i], f_valid[i], c_coords[i],
                                 c_valid[i], c_feats[i], w)
        np.testing.assert_allclose(got[i].numpy(), oracle, rtol=1e-4,
                                   atol=1e-4)
        assert np.abs(oracle).sum() > 0


def test_win_inverse_conv_counts_overflow():
    """A window smaller than a block's span loses neighbours and says so,
    as the reference's does."""
    c = inverse_case(0)
    w = np.ones((27, 4, 2), np.float32)
    args = [t(a)[None] for a in (c[3], c[4], c[5], c[0], c[2])]
    _, ovf = tso.win_inverse_conv(*args, c[6], c[7], t(w), block=64,
                                  window=8)
    _, jovf = jso.win_inverse_conv(
        *(jnp.asarray(a) for a in (c[3], c[4], c[5], c[0], c[2])), c[6],
        c[7], jnp.asarray(w), block=64, window=8)
    assert int(ovf[0]) == int(jovf) > 0


# ------------------------------------------------------------------ UNetV2

_JAX = {}


def jax_unet(b):
    """The JAX UNetV2's inputs, variables, eval outputs, training outputs,
    the gradient of a fixed linear loss and that loss's weights, at batch
    `b` (1 or 3), from one jit at batch 3 (eval and gradient together):
    batch 1 is batch 3's first scene with the other two emptied, cut back
    to one sample. Eval runs per sample (BN is affine), and training BN's
    statistics and the loss read the actives only, so the empty scenes
    change nothing."""
    if b in _JAX:
        return _JAX[b]
    feats, coords, mask = voxels(3, 3)
    r_pf = np.random.RandomState(5).randn(3, V, 8).astype(np.float32)
    if b == 1:
        for x in (feats, coords, mask, r_pf):
            x[1:] = 0
    batch = {"voxel_features": jnp.asarray(feats),
             "voxel_coords": jnp.asarray(coords),
             "voxel_mask": jnp.asarray(mask)}
    if "fn" not in _JAX:
        mod = jun.UNetV2(model_cfg=EDict(CFG), input_channels=4,
                         grid_size=GRID, voxel_size=VOXEL,
                         point_cloud_range=PCR)
        _JAX["variables"] = random_like(jax.eval_shape(
            lambda: mod.init(jax.random.PRNGKey(0), dict(batch), False)), 1)

        def run(v, bt, train):
            out, _ = mod.apply(v, dict(bt), train, mutable=["batch_stats"])
            return out

        def pick(out):
            ms = out["multi_scale_3d_features"]
            return {"point_features": out["point_features"],
                    "point_coords": out["point_coords"],
                    "point_valid": out["point_valid"],
                    "encoded": out["encoded_spconv_tensor"],
                    "ovf": out["sparse_window_overflow"],
                    **{f"{k}_{n}": ms[k][1][i] for k in ms
                       for i, n in ((0, "ids"), (2, "valid"), (3, "feats"))}}

        def loss(params, rest, bt, r):
            out = run({**rest, "params": params}, bt, True)
            enc = out["encoded_spconv_tensor"]
            return jnp.sum(out["point_features"] * r) \
                + jnp.sum(jnp.sin(enc)), pick(out)

        def both(v, bt, r):
            rest = {k: x for k, x in v.items() if k != "params"}
            (_, tr), grads = jax.value_and_grad(loss, has_aux=True)(
                v["params"], rest, bt, r)
            return pick(run(v, bt, False)), tr, grads

        _JAX["fn"] = jax.jit(both)
    variables = _JAX["variables"]
    with jax.default_matmul_precision("highest"):
        ev, tr, grads = jax.tree.map(np.asarray, _JAX["fn"](
            variables, batch, jnp.asarray(r_pf)))
    inputs = (feats, coords, mask)
    if b == 1:
        def one(x):
            return x[:1] if x.ndim else x
        inputs, r_pf = tuple(x[:1] for x in inputs), r_pf[:1]
        ev, tr = jax.tree.map(one, ev), jax.tree.map(one, tr)
    _JAX[b] = (inputs, variables, ev, tr, grads, r_pf)
    return _JAX[b]


def torch_unet(mode, variables):
    cfg = dict(CFG)
    if mode != "xla":
        cfg.update(SUBM_IMPL=mode, **KERNEL_CFG)
    mod = tun.UNetV2(EDict(cfg), 4, GRID, VOXEL, PCR)
    from_jax_variables(variables, mod)
    return mod


def valid_rows(x, valid):
    return [x[i][valid[i]] for i in range(len(x))]


def same_level(got, want, tol):
    """Equal valid rows in order (the modes pad to other block sizes)."""
    g_valid, w_valid = got["point_valid"], want["point_valid"]
    assert g_valid.sum() == w_valid.sum() > 0
    for gi, wi in zip(valid_rows(got["point_coords"], g_valid),
                      valid_rows(want["point_coords"], w_valid)):
        np.testing.assert_allclose(gi, wi, rtol=1e-6, atol=1e-6)
    for gi, wi in zip(valid_rows(got["point_features"], g_valid),
                      valid_rows(want["point_features"], w_valid)):
        np.testing.assert_allclose(gi, wi, rtol=tol, atol=tol)
    for L in (1, 2, 3, 4):
        gv, wv = got[f"x_conv{L}_valid"], want[f"x_conv{L}_valid"]
        for gi, wi in zip(valid_rows(got[f"x_conv{L}_ids"], gv),
                          valid_rows(want[f"x_conv{L}_ids"], wv)):
            np.testing.assert_array_equal(gi, wi)
        for gi, wi in zip(valid_rows(got[f"x_conv{L}_feats"], gv),
                          valid_rows(want[f"x_conv{L}_feats"], wv)):
            np.testing.assert_allclose(gi, wi, rtol=tol, atol=tol)
    # the dense conv_out map, channels-first in the port
    np.testing.assert_allclose(np.moveaxis(got["encoded"], 1, -1),
                               want["encoded"], rtol=tol, atol=tol)


def torch_pick(out):
    ms = out["multi_scale_3d_features"]
    res = {"point_features": out["point_features"],
           "point_coords": out["point_coords"],
           "point_valid": out["point_valid"],
           "encoded": out["encoded_spconv_tensor"],
           "ovf": out["sparse_window_overflow"]}
    for k, lv in ms.items():
        for i, n in ((0, "ids"), (2, "valid"), (3, "feats")):
            res[f"{k}_{n}"] = lv[1][i]
    return {k: v.detach().numpy() for k, v in res.items()}


def torch_batch(inputs):
    feats, coords, mask = inputs
    return {"voxel_features": t(feats), "voxel_coords": t(coords),
            "voxel_mask": t(mask)}


@pytest.mark.parametrize("mode", ["xla", "posgather", "pallas"])
@pytest.mark.parametrize("b", [1, 3])
def test_unet_forward_matches_jax(b, mode):
    inputs, variables, ev, _, _, _ = jax_unet(b)
    assert int(ev["ovf"]) == 0
    mod = torch_unet(mode, variables).eval()
    with torch.no_grad():
        got = torch_pick(mod(torch_batch(inputs)))
    assert int(got["ovf"]) == 0
    same_level(got, ev, FEAT_TOL)


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("b", [1, 3])
def test_unet_gradient_matches_jax(b, mode):
    """Training mode (batch-statistic BN): the forward and the gradient of
    sum(point_features * R) + sum(sin(encoded)) with respect to every
    parameter."""
    inputs, variables, _, tr, grads, r_pf = jax_unet(b)
    mod = torch_unet(mode, variables).train()
    out = mod(torch_batch(inputs))
    loss = (out["point_features"][:, :V] * t(r_pf)).sum() \
        + torch.sin(out["encoded_spconv_tensor"]).sum()
    loss.backward()
    assert int(out["sparse_window_overflow"]) == 0
    same_level(torch_pick(out), tr, FEAT_TOL)
    got, want = flat(to_jax_tree(mod, "grad")), flat(grads)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg="/".join(k))
    assert sum(float(np.abs(w).sum()) for w in want.values()) > 0


def test_unet_pallas_mode_matches_jax_pallas_interpret():
    inputs, variables, *_ = jax_unet(1)
    cfg = dict(CFG, SUBM_IMPL="pallas", PALLAS_INTERPRET=True,
               WINDOWED_PRECISION="highest", **KERNEL_CFG)
    jmod = jun.UNetV2(model_cfg=EDict(cfg), input_channels=4,
                      grid_size=GRID, voxel_size=VOXEL,
                      point_cloud_range=PCR)
    feats, coords, mask = inputs

    def run(v, f, c, m):
        out, _ = jmod.apply(v, {"voxel_features": f, "voxel_coords": c,
                                "voxel_mask": m}, False,
                            mutable=["batch_stats"])
        return (out["point_features"], out["point_valid"],
                out["encoded_spconv_tensor"], out["sparse_window_overflow"])

    with jax.default_matmul_precision("highest"):
        pf, pv, enc, ovf = jax.tree.map(np.asarray, jax.jit(run)(
            variables, feats, coords, mask))
    assert int(ovf) == 0
    mod = torch_unet("pallas", variables).eval()
    with torch.no_grad():
        got = torch_pick(mod(torch_batch(inputs)))
    np.testing.assert_array_equal(got["point_valid"], pv)
    np.testing.assert_allclose(got["point_features"], pf, rtol=FEAT_TOL,
                               atol=FEAT_TOL)
    np.testing.assert_allclose(np.moveaxis(got["encoded"], 1, -1), enc,
                               rtol=FEAT_TOL, atol=FEAT_TOL)


def test_parameters_keep_the_flax_names():
    _, variables, *_ = jax_unet(1)
    mod = torch_unet("xla", variables)
    for coll in ("params", "batch_stats"):
        got = flat(to_jax_tree(mod, "param" if coll == "params" else coll))
        want = flat(variables[coll])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_unet_refuses_the_gather_mode():
    _, variables, *_ = jax_unet(1)
    mod = tun.UNetV2(EDict(dict(CFG, SUBM_MODE="gather")), 4, GRID, VOXEL,
                     PCR)
    inputs = jax_unet(1)[0]
    with pytest.raises(ValueError, match="windowed"):
        mod.eval()(torch_batch(inputs))


# ------------------------------------------------------- launches per mode


class FakeLib(_EmuLib):
    """The K3 / K4 emulation of tests/test_torch_windowed_sparse.py plus
    K1 (the plain prelude and ranks) and K2 (the plain gather conv) over
    the arguments the wrappers pass."""

    def fp_level_positions(self, src, tgt, lo, base, hr, ovf, pos, deltas,
                           sentinel, has_sentinel, b, vs, vt, block, window,
                           tap_window, stage, stream):
        self.calls.append(("positions", deltas.n))
        mids = np.asarray(list(deltas.d)[:deltas.n])
        d27 = np.concatenate([mids + zi - 1 for zi in range(3)])
        lp = TP.compute_positions_plain(
            src, tgt, d27, block, window, tap_window or None,
            sentinel if has_sentinel else None)
        for dst, val in ((lo, lp.lo), (base, lp.base), (hr, lp.has_real),
                         (ovf, lp.overflow), (pos, lp.pos)):
            dst.copy_(val)
        return 0

    def fp_posgather_conv(self, src, feats, tgt, pos, lo, has_real, gdeltas,
                          w, scale, shift, out, b, vs, vt, nb, g_n, block,
                          window, ci, co, epi, relu, sent, acc, stream):
        self.calls.append(("posgather_conv", g_n, ci, co))
        res = TP.posgather_conv_plain(src, feats.float(), tgt, pos, lo,
                                      has_real, gdeltas,
                                      unpack_mma(w).float(), block, window)
        if acc:
            res = res + out
        if epi:
            res = res * scale + shift
            res = (torch.relu(res) if relu else res) * (tgt < sent)[..., None]
        out.copy_(res)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    fake = FakeLib()
    for m in (TP, ws):
        monkeypatch.setattr(m, "_check_device", lambda *a: True)
        monkeypatch.setattr(m, "_lib", lambda: fake)
        monkeypatch.setattr(m, "_stream", lambda: None)
        monkeypatch.setattr(m, "_ptr", lambda x: x)
    monkeypatch.setattr(TP, "_DELTAS", {})
    monkeypatch.setattr(ws, "_compute_dtype", lambda x: torch.bfloat16)
    TP.reset_launches()
    ws.reset_launches()
    yield fake
    TP.reset_launches()
    ws.reset_launches()


def launches():
    return {**TP.LAUNCHES, **ws.LAUNCHES}


@pytest.mark.parametrize("mode,train,want", [
    ("posgather", False, {"positions": 4, "posgather_conv": 4,
                          "windowed_conv": 21, "windowed_dw": 0}),
    ("pallas", False, {"positions": 0, "posgather_conv": 0,
                       "windowed_conv": 25, "windowed_dw": 0}),
    ("posgather", True, {"positions": 0, "posgather_conv": 0,
                         "windowed_conv": 49, "windowed_dw": 25}),
    ("pallas", True, {"positions": 0, "posgather_conv": 0,
                      "windowed_conv": 49, "windowed_dw": 25})])
def test_launches_per_mode(fake_card, mode, train, want):
    """Through the CUDA branches against the fake library: the reference's
    dispatch (training: K3 forward, K3 transposed but for the input conv,
    whose voxel features need no gradient, and K4; the inverse convs
    none), conv_out's single tap group at K1 / K2, and finite outputs."""
    inputs, variables, *_ = jax_unet(1)
    mod = torch_unet(mode, variables).train(train)
    with torch.set_grad_enabled(train):
        out = mod(torch_batch(inputs))
        if train:
            (out["point_features"].sum()
             + out["encoded_spconv_tensor"].sum()).backward()
    assert launches() == want
    groups = [c[1] for c in fake_card.calls if c[0] == "positions"]
    assert sorted(groups) == ([1, 9, 9, 9] if want["positions"] else [])
    assert bool(torch.isfinite(out["point_features"]).all())
    assert int(out["sparse_window_overflow"]) == 0
