"""The plain reference on the CPU: its sparse pieces against brute force,
and the whole reference against the port at a narrow width on a cropped
scene, as a run of each cell compares them."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import harness
from benchmark.reference import sparse


def test_voxelize_mean_against_a_loop():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2.0, 2.0, (400, 4)).astype(np.float32)
    pcr, vs = [-1.5, -1.5, -1.0, 1.5, 1.5, 1.0], [0.5, 0.5, 0.5]
    coords, means = sparse.voxelize_mean(torch.from_numpy(pts), pcr, vs,
                                         max_voxels=20, max_points=3)
    cells = {}
    for p in pts:
        c = np.floor((p[:3] - np.float32(pcr[:3])) / np.float32(vs))
        if (p[:3] < pcr[:3]).any() or (p[:3] >= pcr[3:]).any():
            continue
        lin = (int(c[2]) * 6 + int(c[1])) * 6 + int(c[0])
        cells.setdefault(lin, []).append(p)
    want = sorted(cells)[:20]
    assert coords.shape[0] == len(want)
    for row, lin in enumerate(want):
        x, y, z = lin % 6, (lin // 6) % 6, lin // 36
        assert coords[row].tolist() == [z, y, x]
        np.testing.assert_allclose(means[row].numpy(),
                                   np.mean(cells[lin][:3], axis=0),
                                   rtol=1e-6, atol=1e-6)


def test_sparse_conv_against_a_dense_conv():
    """On an active set of a small grid, the submanifold conv equals a
    dense 3x3x3 conv read at the active cells, and the strided conv a
    dense stride-2 conv read at the active outputs."""
    g = torch.Generator().manual_seed(0)
    shape = (5, 6, 7)
    occ = torch.rand(shape, generator=g) < 0.3
    coords = torch.nonzero(occ)
    feats = torch.randn(coords.shape[0], 3, generator=g)
    w = sparse.SparseConvParam(3, 4)
    with torch.no_grad():
        w.kernel.copy_(torch.randn(27, 3, 4, generator=g))
    dense = torch.zeros((3,) + shape)
    dense[(slice(None),) + tuple(coords.T)] = feats.T
    weight = w.kernel.reshape(3, 3, 3, 3, 4).permute(4, 3, 0, 1, 2)
    lv = sparse.Level(coords, feats, shape)
    with torch.no_grad():
        got = sparse.sparse_conv(lv, coords, w, (1, 1, 1), (1, 1, 1), None,
                                 [])
        ref = F.conv3d(dense[None], weight, padding=1)[0]
        torch.testing.assert_close(got, ref[(slice(None),)
                                            + tuple(coords.T)].T)
        out_shape = tuple(sparse.conv_out_dim(n, 3, 2, 1) for n in shape)
        oc, _ = sparse.strided_active_set(lv, out_shape, (3, 3, 3),
                                          (2, 2, 2), (1, 1, 1), None)
        got = sparse.sparse_conv(lv, oc, w, (2, 2, 2), (1, 1, 1), None, [])
        ref = F.conv3d(dense[None], weight, stride=2, padding=1)[0]
        torch.testing.assert_close(got, ref[(slice(None),) + tuple(oc.T)].T)
        reach = F.max_pool3d(occ[None, None].float(), 3, 2, 1)[0, 0] > 0
        assert torch.equal(torch.nonzero(reach), oc)


def test_active_counts_alone_equal_the_forward_counts():
    """The active sets without the convolutions, as the check counts every
    scene of a batch, equal the counts of the whole backbone."""
    cfg = {"CHANNELS": [16, 4, 4, 4, 4], "OUT_CHANNELS": 4,
           "LEVEL_CAPACITIES": [400, 400, 100, 40, 20], "SUBM_MODE": "windowed",
           "WINDOWED_BLOCK": 8}
    net = sparse.VoxelResBackBone8x(cfg, 5, (24, 24, 40))
    g = torch.Generator().manual_seed(1)
    coords = torch.unique(torch.stack([
        torch.randint(0, 41, (300,), generator=g),
        torch.randint(0, 24, (300,), generator=g),
        torch.randint(0, 24, (300,), generator=g)], -1), dim=0)
    with torch.no_grad():
        _, counts, book, cut = net(coords, torch.randn(coords.shape[0], 5,
                                                       generator=g))
    assert cut     # level 2's 100 (rounded to 104) cut cells
    assert net.active_counts(coords) == counts
    assert [c["level"] for c in book] == [1] * 5 + [2] * 5 + [3] * 5 \
        + [4] * 5 + [5]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_reference_against_the_port(narrow_root, cell):
    """A whole run of the cell at a narrow width on the CPU: the port
    within the cell's limits of the reference, exact where they are 0."""
    torch.manual_seed(0)
    result, lines = harness.run_cell(cell, 987654321, 0.5, False, 0.0,
                                     narrow_root, device="cpu")
    assert result["correct"], lines
    checks = result["checks"]
    assert checks["actives"]["value"] == 0
    assert checks["decode_err"]["value"] == 0
    assert set(result["metrics"]) == {
        m["name"] for m in harness.cell_metrics(harness.load_spec(), cell,
                                                False)}
