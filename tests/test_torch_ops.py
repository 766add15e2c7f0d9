"""PyTorch port against the JAX package, CPU, small sizes: voxelization and
sparse-level bookkeeping (exact), the transformer decoder layer, top-k tie
order, the port's isolation from jax, and its refusal to fall back to the
CPU on its own."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import findnpropagate_torch
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models.model_utils.transformer import (
    TransformerDecoderLayer,
)
from findnpropagate_torch.models.post_processing import (
    top_k_lower_index_first,
)
from findnpropagate_torch.ops import sparse_ops as TS
from findnpropagate_torch.ops.voxelize import voxelize_mean
from findnpropagate_torch.utils.weights import from_jax_variables
from findnpropagate_tpu.models.model_utils import transformer as jtr
from findnpropagate_tpu.ops import sparse_ops as JS
from findnpropagate_tpu.ops import voxelize as jvox

ROOT = Path(__file__).resolve().parents[1]
DATA_CFG = {
    "POINT_CLOUD_RANGE": [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0],
    "SYNTHETIC": {"NUM_SCENES": 2, "NUM_OBJECTS": 10,
                  "NUM_RAW_POINTS": 20000, "PATTERN": "lidar_ring"},
    "CAPACITIES": {"MAX_POINTS": 24000, "MAX_VOXELS": 9000,
                   "MAX_POINTS_PER_VOXEL": 10},
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"]},
    "DATA_PROCESSOR": [{"NAME": "transform_points_to_voxels",
                        "VOXEL_SIZE": [0.075, 0.075, 0.2]}],
}


@pytest.mark.parametrize("max_voxels", [30000, 2000])
def test_voxelize_mean_exact(max_voxels):
    """Same coords, counts, mask and bit-equal means, with the cap unhit
    and hit (the same voxels are dropped)."""
    ds = SyntheticDataset(DATA_CFG, ["car", "pedestrian"], training=False)
    batch = ds.batch([0, 1])
    args = (tuple(ds.point_cloud_range), tuple(ds.voxel_size),
            tuple(int(g) for g in ds.grid_size), max_voxels, 10)
    ref = jax.vmap(lambda p, m: jvox.voxelize_mean(p, m, *args))(
        jnp.asarray(batch["points"]), jnp.asarray(batch["points_mask"]))
    got = voxelize_mean(torch.from_numpy(batch["points"]),
                        torch.from_numpy(batch["points_mask"]), *args)
    for field in ("means", "coords", "num_points", "voxel_mask",
                  "num_voxels"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    assert (int(got.num_voxels.max()) == max_voxels) == (max_voxels == 2000)


def _active_set(seed, b=3, shape=(41, 32, 32), n=300, v=400):
    rng = np.random.RandomState(seed)
    nz, ny, nx = shape
    coords = np.full((b, v, 3), -1, np.int32)
    valid = np.zeros((b, v), bool)
    for i in range(b):
        lin = rng.choice(nz * ny * nx, n, replace=False)
        coords[i, :n] = np.stack([lin // (ny * nx), (lin // nx) % ny,
                                  lin % nx], 1)
        valid[i, :n] = True
    return coords, valid, shape


@pytest.mark.parametrize("impl", ["win_downsample", "win_downsample_dense"])
@pytest.mark.parametrize("max_out", [2048, 500])
def test_downsample_exact(impl, max_out):
    coords, valid, s1 = _active_set(1)
    s2 = tuple((n + 2 - 3) // 2 + 1 for n in s1)
    ref = jax.vmap(lambda c, v: getattr(JS, impl)(c, v, s1, s2, max_out))(
        jnp.asarray(coords), jnp.asarray(valid))
    got = getattr(TS, impl)(torch.from_numpy(coords),
                            torch.from_numpy(valid), s1, s2, max_out)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_id_helpers_exact():
    coords, valid, s1 = _active_set(2)
    s2 = tuple((n + 2 - 3) // 2 + 1 for n in s1)
    c, v = torch.from_numpy(coords), torch.from_numpy(valid)
    np.testing.assert_array_equal(
        TS.yxz_linear_ids(c, v, s1).numpy(),
        np.asarray(jax.vmap(lambda a, b: JS.yxz_linear_ids(a, b, s1))(
            jnp.asarray(coords), jnp.asarray(valid))))
    for k, st, pad in (((3, 3, 3), (2, 2, 2), (1, 1, 1)),
                       ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
                       ((3, 1, 1), (2, 1, 1), (0, 0, 0))):
        np.testing.assert_array_equal(TS.strided_deltas(k, st, pad, s1),
                                      JS.strided_deltas(k, st, pad, s1))
    np.testing.assert_array_equal(TS.yxz_offset_deltas((3, 3, 3), s1),
                                  JS.yxz_offset_deltas((3, 3, 3), s1))
    assert TS.yxz_sentinel_start(s1) == JS.yxz_sentinel_start(s1)
    assert TS.strided_sentinel_start(s1) == JS.strided_sentinel_start(s1)
    oi, oc, ov = JS.win_downsample(jnp.asarray(coords[0]),
                                   jnp.asarray(valid[0]), s1, s2, 1024)
    np.testing.assert_array_equal(
        TS.strided_base_ids(torch.from_numpy(np.array(oc))[None],
                            torch.from_numpy(np.array(ov))[None],
                            (2, 2, 2), s1, s2)[0].numpy(),
        np.asarray(JS.strided_base_ids(oc, ov, (2, 2, 2), s1, s2)))
    feats = np.random.RandomState(3).randn(*coords.shape[:2], 5).astype(
        np.float32)
    ref = jax.vmap(lambda a, b, f: JS.coords_to_dense(a, b, f, s1))(
        jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(feats))
    got = TS.coords_to_dense(c, v, torch.from_numpy(feats), s1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(ref))


def test_decoder_layer_matches_jax():
    """f32 on both sides, JAX matmuls at highest precision; 1e-5 covers
    the different summation orders of the attention and FFN products."""
    rng = np.random.RandomState(0)
    q = rng.randn(2, 6, 32).astype(np.float32)
    k = rng.randn(2, 40, 32).astype(np.float32)
    qp = rng.uniform(0, 8, (2, 6, 2)).astype(np.float32)
    kp = rng.uniform(0, 8, (2, 40, 2)).astype(np.float32)
    layer = jtr.TransformerDecoderLayer(d_model=32, nhead=4,
                                        dim_feedforward=64)
    args = [jnp.asarray(a) for a in (q, k, qp, kp)]
    variables = layer.init(jax.random.PRNGKey(1), *args, train=False)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.2, a.shape).astype(
            np.float32), variables)
    with jax.default_matmul_precision("highest"):
        ref = layer.apply(variables, *args, train=False)
    tl = TransformerDecoderLayer(32, 4, 64).eval()
    from_jax_variables(variables, tl)
    with torch.no_grad():
        got = tl(*(torch.from_numpy(a) for a in (q, k, qp, kp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_top_k_ties_lower_index_first():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 4, (3, 500)).astype(np.float32)
    x[1] = 0.0
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 64)
    got_v, got_i = top_k_lower_index_first(torch.from_numpy(x), 64)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|findnpropagate_tpu)\b", re.M)


def test_port_imports_no_jax():
    """The port's sources and chip_smoke.py import nothing of jax or of
    the JAX package, and the whole port imports with jax blocked."""
    files = sorted((ROOT / "findnpropagate_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f) for f in files if IMPORT_RE.search(f.read_text())]
    assert not offenders, offenders
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                  'findnpropagate_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import findnpropagate_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_silent_cpu_fallback(monkeypatch):
    """With no CUDA and no device named, entry points raise; naming the
    CPU is the only way onto it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        findnpropagate_torch.resolve_device()
    from findnpropagate_torch.config import cfg_from_yaml_file
    from findnpropagate_torch.models import build_network

    cfg = cfg_from_yaml_file(
        str(ROOT / "tools/cfgs/nuscenes_models/transfusion_lidar.yaml"))
    ds = SyntheticDataset(DATA_CFG, cfg.CLASS_NAMES, training=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_network(cfg.MODEL, num_class=10, dataset=ds)
    assert findnpropagate_torch.resolve_device("cpu").type == "cpu"


def test_build_target_follows_included_headers(tmp_path, monkeypatch):
    """The library's name hashes the source and the headers it includes
    (one including another too), so a changed header is rebuilt; a system
    include or a missing file is not followed."""
    from findnpropagate_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\n  # include "gone.h"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    assert [f.name for f in _build.source_files(tmp_path / "k.cu")] == [
        "k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")[1]
    assert _build._target("k")[1] == first
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _build._target("k")[1] != first
    # the port's own sources: both kernels' files include the shared header
    monkeypatch.undo()
    for name in ("posgather", "windowed_sparse"):
        assert "gather_mma.cuh" in [
            f.name for f in _build.source_files(_build.CSRC / f"{name}.cu")]


def test_ptxas_spill_report_is_parsed():
    from findnpropagate_torch.ops import _build

    log = """ptxas info    : Compiling entry function '_Z1aILi2EEvPi' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi2EEvPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Function properties for _Z1bILi8EEvPf
    40 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers
"""
    assert _build.spills(log) == {"_Z1aILi2EEvPi": 0, "_Z1bILi8EEvPf": 40}
    assert _build.spills("") == {}
