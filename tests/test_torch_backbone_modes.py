"""VoxelResBackBone8x of the port in each backbone mode of the reference,
against the JAX backbone with carried weights (the flax->torch weight
bridge), at batch 1 (dense downsample) and batch 3 (sort downsample); with
it the backbone options DENSE_CHUNK, ASSUME_SORTED, DOWNSAMPLE_IMPL and
FUSE_BN_EPILOGUE: False, BaseBEVBackbone's DTYPE: bf16, stride < 1
deblocks, deblock_extra and levels without upsampling, and the decoder's
cross_only.

Modes: gather (``SUBM_MODE`` unset, the self-training yamls' backbone)
against the JAX gather backbone; windowed with ``SUBM_IMPL: xla`` against
the JAX XLA windowed backbone (``WINDOWED_PRECISION: highest``); windowed
with posgather and pallas against the JAX gather backbone, the exact path,
where the reference's overflow is 0 (its posgather path compiles for minutes
in Pallas interpret mode; tests/test_torch_backbone.py holds it).

Tolerances: active counts and overflow exact; outputs 1e-4 absolute and
relative (float32 on both sides, the 27 * Cin products and BN sums in other
orders through 16 sparse and 6 dense convs); gradients of a training step
(batch-statistic BN) per leaf within 1e-3 of the leaf's largest entry and
1e-6 of the largest gradient of all, plus rtol 1e-3 (the conv biases
ahead of a batch-statistic BN have a gradient of 0, rounding noise of
~1e-6 on both sides), BN statistics rtol 1e-4 / atol 1e-6; bf16 BEV outputs within 2
bf16 steps (2^-7) of the output's scale (each of 5 convs rounds its output
to bf16, in another summation order on each side)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.models.backbones_2d.base_bev_backbone import (
    BaseBEVBackbone as TorchBEV,
)
from findnpropagate_torch.models.backbones_3d.spconv_backbone import (
    VoxelResBackBone8x as TorchBackbone,
)
from findnpropagate_torch.models.model_utils.transformer import (
    TransformerDecoderLayer as TorchDecoderLayer,
)
from findnpropagate_torch.ops.sparse_ops import yxz_linear_ids
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.models.backbones_2d.base_bev_backbone import (
    BaseBEVBackbone,
)
from findnpropagate_tpu.models.backbones_3d import VoxelResBackBone8x
from findnpropagate_tpu.models.model_utils.transformer import (
    TransformerDecoderLayer,
)
from test_torch_backbone import GRID, _random_bn, make_batch

BASE = {"MAX_VOXELS": 512, "DENSE_FROM_LEVEL": 2, "DENSE_DTYPE": "f32",
        "LEVEL_CAPACITIES": [512, 512, 2048, 2048, 2048],
        "CHANNELS": [16, 16, 16, 16, 16], "OUT_CHANNELS": 16}
WIN = dict(BASE, SUBM_MODE="windowed", WINDOWED_BLOCK=512,
           WINDOWED_WINDOW=2048, WINDOWED_PRECISION="highest")
MODES = {"gather": BASE,
         "xla": dict(WIN, SUBM_IMPL="xla"),
         "posgather": dict(WIN, SUBM_IMPL="posgather"),
         "pallas": dict(WIN, SUBM_IMPL="pallas")}
# the JAX backbone each mode of the port is held against
REFERENCE = {"gather": "gather", "xla": "xla", "posgather": "gather",
             "pallas": "gather"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_backbone(cfg):
    return VoxelResBackBone8x(model_cfg=cfg, input_channels=4,
                              grid_size=GRID)


KEYS = ("encoded_spconv_tensor", "sparse_active_counts",
        "sparse_window_overflow")


def run_jax(cfg, variables, batch, train=False):
    """The JAX backbone's arrays of interest (jitted: one compile per
    config and batch shape)."""
    def run(v, b):
        out = jax_backbone(cfg).apply(v, b, train=train,
                                      mutable=["batch_stats"] if train
                                      else False)
        out, upd = out if train else (out, None)
        keep = {k: out[k] for k in KEYS if k in out}
        return (keep, upd) if train else keep
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return run(variables, jb) if train else jax.jit(run)(variables, jb)


def port(cfg, variables, train=False):
    tbb = TorchBackbone(cfg, 4, GRID)
    from_jax_variables(variables, tbb)
    return tbb.train(train)


def run_port(tbb, batch):
    with torch.no_grad():
        return tbb({k: torch.from_numpy(v) for k, v in batch.items()})


def dense(out):
    return out["encoded_spconv_tensor"].permute(0, 2, 3, 4, 1).numpy()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(5)
    batch = make_batch(rng, 3, n=200, v_cap=300)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_bn(jax_backbone(BASE).init(
        jax.random.PRNGKey(1), dict(jb), train=False), rng)
    variables = jax.tree.map(np.asarray, variables)
    refs = {}
    for name in ("gather", "xla"):
        ref = run_jax(MODES[name], variables, batch)
        if name == "xla":
            assert int(ref["sparse_window_overflow"]) == 0
        refs[name] = ref
    return batch, variables, refs


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_backbone_mode_matches_jax(setup, mode, b):
    batch, variables, refs = setup
    ref = refs[REFERENCE[mode]]
    got = run_port(port(MODES[mode], variables),
                   {k: v[:b] for k, v in batch.items()})
    assert int(got["sparse_window_overflow"]) == 0
    assert got["sparse_window_overflow"].shape == ()
    if b == 3:
        np.testing.assert_array_equal(got["sparse_active_counts"].numpy(),
                                      np.asarray(ref["sparse_active_counts"]))
    np.testing.assert_allclose(dense(got),
                               np.asarray(ref["encoded_spconv_tensor"])[:b],
                               rtol=1e-4, atol=1e-4)


def test_gather_mode_equals_posgather_mode(setup):
    """Where the reference's overflow is 0 the gather backbone and the
    posgather backbone compute the same function."""
    batch, variables, _ = setup
    a = run_port(port(MODES["gather"], variables), batch)
    b = run_port(port(MODES["posgather"], variables), batch)
    np.testing.assert_array_equal(a["sparse_active_counts"].numpy(),
                                  b["sparse_active_counts"].numpy())
    np.testing.assert_allclose(dense(a), dense(b), rtol=1e-4, atol=1e-4)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("mode", ["gather", "xla", "posgather"])
def test_training_step_gradients_match_jax(setup, mode, b):
    """One training forward (batch-statistic BN) and the gradients of
    sum(output * g) for every parameter, and the BN statistics it
    records."""
    batch, variables, _ = setup
    batch = {k: v[:b] for k, v in batch.items()}
    cfg = MODES[mode]
    g = np.random.RandomState(b).randn(
        *np.asarray(run_jax(MODES[REFERENCE[mode]], variables, batch)[
            "encoded_spconv_tensor"]).shape).astype(np.float32)

    def loss(params):
        out, upd = run_jax(MODES[REFERENCE[mode]], {
            "params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True)
        return jnp.sum(out["encoded_spconv_tensor"] * g), upd

    (_, upd), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    tbb = port(cfg, variables, train=True)
    out = tbb({k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(out["sparse_window_overflow"]) == 0
    (out["encoded_spconv_tensor"].permute(0, 2, 3, 4, 1)
     * torch.from_numpy(g)).sum().backward()
    want, got = flat(jgrad), flat(to_jax_tree(tbb, "grad"))
    assert set(want) == set(got)
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-3 * scale + 1e-6 * top,
                                   err_msg=str(k))
    want, got = flat(upd["batch_stats"]), flat(to_jax_tree(tbb,
                                                           "batch_stats"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=str(k))


@pytest.mark.parametrize("mode", ["xla", "posgather"])
def test_dense_chunk_matches_jax(setup, mode):
    """DENSE_CHUNK: the eval dense tail in 3 batch chunks equals the JAX
    chunked tail and the unchunked run."""
    batch, variables, refs = setup
    cfg = dict(MODES[mode], DENSE_CHUNK=3)
    got = run_port(port(cfg, variables), batch)
    if mode == "xla":
        ref = run_jax(cfg, variables, batch)
        assert int(ref["sparse_window_overflow"]) == 0
    else:
        ref = refs["gather"]
    np.testing.assert_array_equal(got["sparse_active_counts"].numpy(),
                                  np.asarray(ref["sparse_active_counts"]))
    np.testing.assert_allclose(dense(got),
                               np.asarray(ref["encoded_spconv_tensor"]),
                               rtol=1e-4, atol=1e-4)


def test_assume_sorted_matches_jax(setup):
    """ASSUME_SORTED: a batch already in (y, x, z) id order skips the
    entry sort, in both packages, and gives the unsorted run's output."""
    batch, variables, refs = setup
    ids = yxz_linear_ids(torch.from_numpy(batch["voxel_coords"]),
                         torch.from_numpy(batch["voxel_mask"]),
                         TorchBackbone(BASE, 4, GRID).level_shapes[0])
    order = torch.argsort(ids, dim=1).numpy()
    srt = {k: np.take_along_axis(
        v, order.reshape(order.shape + (1,) * (v.ndim - 2)), axis=1)
        for k, v in batch.items()}
    cfg = dict(MODES["xla"], ASSUME_SORTED=True)
    ref = run_jax(cfg, variables, srt)
    got = run_port(port(cfg, variables), srt)
    np.testing.assert_allclose(dense(got),
                               np.asarray(ref["encoded_spconv_tensor"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dense(got),
                               np.asarray(refs["xla"]["encoded_spconv_tensor"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "sort", "scatter"])
@pytest.mark.parametrize("b", [1, 3])
def test_downsample_impl_matches_jax(setup, impl, b):
    """DOWNSAMPLE_IMPL overrides the batch <= 2 rule; every build gives the
    same active sets."""
    batch, variables, refs = setup
    cfg = dict(MODES["xla"], DOWNSAMPLE_IMPL=impl)
    got = run_port(port(cfg, variables), {k: v[:b] for k, v in batch.items()})
    ref = refs["xla"]
    if b == 3:
        np.testing.assert_array_equal(got["sparse_active_counts"].numpy(),
                                      np.asarray(ref["sparse_active_counts"]))
    np.testing.assert_allclose(dense(got),
                               np.asarray(ref["encoded_spconv_tensor"])[:b],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["posgather", "pallas"])
def test_unfused_epilogue_matches_jax(setup, mode):
    """FUSE_BN_EPILOGUE: False runs bias, BN and ReLU after the kernels
    instead of in their epilogue."""
    batch, variables, refs = setup
    got = run_port(port(dict(MODES[mode], FUSE_BN_EPILOGUE=False),
                        variables), batch)
    assert int(got["sparse_window_overflow"]) == 0
    np.testing.assert_allclose(dense(got),
                               np.asarray(refs["gather"][
                                   "encoded_spconv_tensor"]),
                               rtol=1e-4, atol=1e-4)


def test_unknown_impl_is_refused():
    with pytest.raises(ValueError, match="SUBM_IMPL"):
        TorchBackbone(dict(WIN, SUBM_IMPL="spconv"), 4, GRID)
    with pytest.raises(ValueError, match="DOWNSAMPLE_IMPL"):
        TorchBackbone(dict(WIN, DOWNSAMPLE_IMPL="hash"), 4, GRID)


BEV = {
    "bf16": {"LAYER_NUMS": [1, 1], "LAYER_STRIDES": [1, 2],
             "NUM_FILTERS": [8, 16], "UPSAMPLE_STRIDES": [1, 2],
             "NUM_UPSAMPLE_FILTERS": [8, 8], "DTYPE": "bf16"},
    "stride_below_1": {"LAYER_NUMS": [1, 1, 1], "LAYER_STRIDES": [1, 2, 2],
                       "NUM_FILTERS": [8, 8, 16],
                       "UPSAMPLE_STRIDES": [0.5, 1, 2],
                       "NUM_UPSAMPLE_FILTERS": [8, 8, 8]},
    "deblock_extra": {"LAYER_NUMS": [1, 1], "LAYER_STRIDES": [2, 2],
                      "NUM_FILTERS": [8, 16], "UPSAMPLE_STRIDES": [1, 2, 2],
                      "NUM_UPSAMPLE_FILTERS": [8, 8]},
    "no_upsample": {"LAYER_NUMS": [2], "LAYER_STRIDES": [2],
                    "NUM_FILTERS": [8]},
    # one level: a map of odd size takes flax's SAME padding
    "stride_below_1_odd": {"LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                           "NUM_FILTERS": [8], "UPSAMPLE_STRIDES": [0.5],
                           "NUM_UPSAMPLE_FILTERS": [8]},
}


@pytest.mark.parametrize("name", list(BEV))
def test_bev_backbone_options_match_jax(name):
    hw = (15, 17) if name.endswith("odd") else (16, 16)
    cfg = BEV[name]
    rng = np.random.RandomState(0)
    x = rng.randn(2, *hw, 6).astype(np.float32)
    jbev = BaseBEVBackbone(model_cfg=cfg, input_channels=6)
    variables = jbev.init(jax.random.PRNGKey(0),
                          {"spatial_features": jnp.asarray(x)}, train=False)
    variables = _random_bn(jax.tree.map(jnp.asarray, variables), rng)
    ref = jbev.apply(variables, {"spatial_features": jnp.asarray(x)},
                     train=False)
    want = np.asarray(ref["spatial_features_2d"], np.float32)
    tbev = TorchBEV(cfg, 6)
    from_jax_variables(jax.tree.map(np.asarray, variables), tbev)
    tbev.eval()
    assert tbev.num_bev_features == jbev.num_bev_features
    with torch.no_grad():
        got = tbev({"spatial_features": torch.from_numpy(
            x).permute(0, 3, 1, 2)})["spatial_features_2d"]
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    if name == "bf16":
        tol = 2 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bev_bf16_is_eval_only():
    """In training the BEV backbone stays float32 (the reference's DTYPE is
    eval-only)."""
    tbev = TorchBEV(BEV["bf16"], 6).train()
    x = torch.randn(2, 6, 8, 8)
    out = tbev({"spatial_features": x})
    assert out["spatial_features_1x"].dtype == torch.float32


def test_decoder_cross_only_matches_jax():
    rng = np.random.RandomState(1)
    q, k = rng.randn(2, 5, 16), rng.randn(2, 7, 16)
    qp, kp = rng.rand(2, 5, 2), rng.rand(2, 7, 2)
    args = [np.asarray(a, np.float32) for a in (q, k, qp, kp)]
    jl = TransformerDecoderLayer(d_model=16, nhead=2, dim_feedforward=32,
                                 dropout=0.0, cross_only=True)
    variables = jl.init(jax.random.PRNGKey(0),
                        *map(jnp.asarray, args), train=False)
    want = jl.apply(variables, *map(jnp.asarray, args), train=False)
    tl = TorchDecoderLayer(16, 2, 32, dropout=0.0, cross_only=True)
    from_jax_variables(jax.tree.map(np.asarray, variables), tl)
    assert not hasattr(tl, "self_attn") and not hasattr(tl, "norm1")
    with torch.no_grad():
        got = tl.eval()(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    full = TorchDecoderLayer(16, 2, 32, dropout=0.0)
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables(jax.tree.map(np.asarray, variables),
                           copy.deepcopy(full))
