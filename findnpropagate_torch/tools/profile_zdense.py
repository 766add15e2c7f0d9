"""The dense-z pillar submanifold conv (ops/zdense.py, plain PyTorch) timed
beside K3, the port's union-window sparse conv kernel
(`windowed_sparse.windowed_conv`, ops/csrc/windowed_sparse.cu), on one
scene at the main path's L0 scale — port of tools/profile_zdense.py, whose
reference was the Pallas windowed conv.

    python -m findnpropagate_torch.tools.profile_zdense [--device cpu]
        [--v 120000] [--c 16] [--cout 16] [--pillars 57344] [--zc 8]
        [--reps 5]

The scene is the reference tool's: V voxels on the (41, 1440, 1440) grid,
two z cells in each of V/2 random pillars (numpy seed 0); `compare` takes
any voxel list (chip_smoke.py hands it the L0 voxels of bench.py's
lidar_ring scene). Both convs take the same bfloat16 features and
weights and multiply in float32; their outputs are held against each
other on every active voxel (within 1e-3 of the scale plus one bfloat16
step, as K3 rounds its operands), K3's window must drop no neighbour, and
each is timed with CUDA events (host work included) over --reps calls,
pillarize too. Prints one line each; exits 1 when the two disagree, 2
without CUDA unless --device cpu is given (then nothing is timed).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import sparse_ops as so
from ..ops import windowed_sparse as ws
from ..ops import zdense as zd
from ..utils import timing
from ._common import bf16_close, device_of, fmt_ms, parser

SHAPE = (41, 1440, 1440)


def scene(v: int, c: int, shape=SHAPE, seed: int = 0):
    """The reference tool's scene: (coords (V, 3) zyx int32, valid, feats
    (V, C) float32) as numpy arrays; two z cells a pillar."""
    nz, ny, nx = shape
    rng = np.random.RandomState(seed)
    n_pil = v // 2
    py = rng.randint(0, ny, n_pil)
    px = rng.randint(0, nx, n_pil)
    zs = rng.randint(0, nz, (n_pil, 2))
    coords = np.stack([zs.reshape(-1), np.repeat(py, 2), np.repeat(px, 2)],
                      axis=1).astype(np.int32)[:v]
    # a pillar's two draws may land on one cell: keep the first of each
    _, first = np.unique(coords, axis=0, return_index=True)
    valid = np.zeros(len(coords), bool)
    valid[first] = True
    feats = rng.standard_normal((len(coords), c)).astype(np.float32)
    return coords, valid, feats


def compare(coords, valid, feats, weights, shape, pillars: int, zc: int = 8,
            block: int = 1024, window: int = 2048, reps: int = 5):
    """Both convs on one voxel list (tensors on one device; weights (27,
    Cin, Cout)). Returns a dict: the pillar count, the times (ms; None on
    the CPU), max_abs_err of the dense-z output against K3's on the
    active voxels, `ok`, K3's overflow and the active voxels."""
    dev = feats.device
    nz = int(shape[0])
    c = feats.shape[1]
    cuda = dev.type == "cuda"
    bf = feats.to(torch.bfloat16)
    w = weights.to(torch.bfloat16)
    ids2, coords2, pvalid, pfeats, pmask = zd.pillarize(
        coords, valid, bf, shape, pillars, nz)

    def dense():
        return zd.zdense_subm(ids2, pfeats, pmask, pvalid, w, shape, nz, c,
                              zc=zc)
    # K3 on the same voxels: ascending yxz ids, padded to the block
    ids3 = so.yxz_linear_ids(coords[None], valid[None], shape)[0]
    order = torch.argsort(ids3)
    ids3s = ids3[order]
    pad = (-ids3s.numel()) % block
    ids3p = torch.cat([ids3s, ids3s[-1] + 1 + torch.arange(
        pad, dtype=torch.int32, device=dev)])[None]
    f3p = torch.cat([bf[order], bf.new_zeros(pad, c)])[None]
    deltas = so.yxz_offset_deltas((3, 3, 3), shape)

    def k3():
        return ws.windowed_conv(ids3p, f3p, ids3p, w.float(), deltas,
                                block=block, window=window,
                                compute_dtype=torch.bfloat16)

    out_d = dense()
    out_k, overflow = k3()
    # each active voxel's row in both outputs
    cl = coords.long()
    pid = cl[:, 1] * (int(shape[2]) + 2) + cl[:, 2] + 1
    row = torch.searchsorted(ids2.long(), pid)
    sel = torch.nonzero(valid).flatten()
    got = out_d.reshape(pillars, nz, -1)[row[sel], cl[sel, 0]]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=dev)
    want = out_k[0, inv[sel]]
    ok, err = bf16_close(got, want)
    ok = ok and int(overflow.sum()) == 0
    res = {"pillars": int(pvalid.sum()), "pillar_cap": pillars,
           "active_voxels": int(sel.numel()),
           "k3_overflow": int(overflow.sum()), "max_abs_err": err, "ok": ok,
           "zdense_ms": None, "k3_ms": None, "pillarize_ms": None}
    if cuda:
        res["zdense_ms"] = timing.ms(dense, reps)
        res["k3_ms"] = timing.ms(k3, reps)
        res["pillarize_ms"] = timing.ms(lambda: zd.pillarize(
            coords, valid, bf, shape, pillars, nz), reps)
    return res


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--v", type=int, default=120000)
    ap.add_argument("--c", type=int, default=16)
    ap.add_argument("--cout", type=int, default=16)
    ap.add_argument("--pillars", type=int, default=57344)
    ap.add_argument("--zc", type=int, default=8)
    ap.set_defaults(reps=5)
    args = ap.parse_args(argv)
    dev = device_of(args)
    if dev is None:
        return 2
    coords, valid, feats = scene(args.v, args.c)
    w = np.random.RandomState(1).standard_normal(
        (27, args.c, args.cout)).astype(np.float32) * 0.1
    res = compare(torch.from_numpy(coords).to(dev),
                  torch.from_numpy(valid).to(dev),
                  torch.from_numpy(feats).to(dev), torch.from_numpy(w).to(dev),
                  SHAPE, args.pillars, args.zc, reps=args.reps)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"{name}: {res['active_voxels']} voxels in {res['pillars']} "
          f"pillars (cap {res['pillar_cap']}), {args.c}->{args.cout}",
          flush=True)
    print(f"zdense_subm zc={args.zc}: {fmt_ms(res['zdense_ms'])}; K3 "
          f"windowed conv: {fmt_ms(res['k3_ms'])}; pillarize: "
          f"{fmt_ms(res['pillarize_ms'])}; max |zdense - K3| "
          f"{res['max_abs_err']:.3g}, K3 overflow {res['k3_overflow']}",
          flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
