"""The dense-z pillar form of the 3x3x3 sparse conv — port of
findnpropagate_tpu/ops/zdense.py (`pillarize` :67, `depillarize` :139,
`make_zband` :190, `zdense_subm` :217, `zdense_downsample` :284), plain
PyTorch.

The active set is kept per BEV pillar with the z axis dense: features
(V2, nz * C) and an activity mask (V2, nz). A 3x3x3 conv is then nine
pillar-neighbour alignments (the 2D taps, found by searchsorted over the
ascending guard-banded (y, x) pillar ids: one guard column in x, so an id
delta identifies the neighbour) times a z-banded matmul: the three z taps
of a 2D tap fold into one block-banded ((zc + 2) * Cin, zc * Cout) weight
and an output chunk of zc z-cells reads the (zc + 2)-cell input slice.
Inactive cells hold zero features and the outputs are re-masked, which is
the submanifold conv's rule; the strided conv's output set is the 3x3
stride-2 receptive field of the input pillars (and in z of their active
cells). The products run in float32 whatever the input's type.

These functions hold one sample (no batch axis), as the reference's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .sparse_ops import kernel_offsets, yxz_sentinel_start, yxz_strides

INT32_MAX = 2 ** 31 - 1


def _yx_stride(shape):
    """The (y, x)-major pillar id's y stride: one guard cell in x."""
    return int(shape[2]) + 2


def yx_sentinel_start(shape):
    return (int(shape[1]) + 1) * _yx_stride(shape) + 2


def yx_offset_deltas(shape):
    """The nine (dy, dx) pillar-id deltas of a 3x3 BEV neighbourhood,
    row-major over (dy, dx) in {-1, 0, 1}^2 (a list of ints)."""
    sy = _yx_stride(shape)
    return [dy * sy + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def pillarize(coords, valid, feats, shape, v2_cap: int, nz: int):
    """Voxel list -> dense-z pillars. coords (V, 3) zyx; valid (V,); feats
    (V, C). Returns (ids2 (V2,) int32 ascending, coords2 (V2, 2) [y, x]
    (-1 for empty slots), pvalid (V2,), pfeats (V2, nz * C), pmask (V2,
    nz)) with V2 = v2_cap; pillars past v2_cap are dropped."""
    v, c = feats.shape
    dev = feats.device
    sy = _yx_stride(shape)
    cl = coords.long()
    ids2_all = torch.where(valid, cl[:, 1] * sy + (cl[:, 2] + 1),
                           torch.full_like(cl[:, 1], INT32_MAX))
    order = torch.argsort(ids2_all, stable=True)
    ids_s = ids2_all[order]
    z_s = cl[order, 0]
    valid_s = valid[order]
    newseg = torch.cat([valid_s[:1],
                        (ids_s[1:] != ids_s[:-1]) & valid_s[1:]])
    pslot = torch.cumsum(newseg.long(), 0) - 1
    pslot = torch.where(valid_s, pslot, torch.full_like(pslot, v2_cap))
    num = min(int(torch.where(valid_s, pslot + 1, 0).max()) if v else 0,
              v2_cap)
    keep = valid_s & (pslot < v2_cap)
    ps = torch.where(keep, pslot, torch.full_like(pslot, v2_cap))
    zc = torch.where(keep, torch.clamp(z_s, 0, nz - 1), 0)
    pfeats = torch.zeros(v2_cap + 1, nz, c, dtype=feats.dtype, device=dev)
    pfeats[ps, zc] = torch.where(keep[:, None], feats[order],
                                 torch.zeros((), dtype=feats.dtype,
                                             device=dev))
    pmask = torch.zeros(v2_cap + 1, nz, dtype=torch.bool, device=dev)
    pmask[ps, zc] = keep
    pids = torch.zeros(v2_cap + 1, dtype=torch.long, device=dev)
    pids[torch.where(newseg & keep, ps, v2_cap)] = ids_s
    pvalid = torch.arange(v2_cap, device=dev) < num
    slot = torch.arange(v2_cap, device=dev)
    ids2 = torch.where(pvalid, pids[:v2_cap], yx_sentinel_start(shape)
                       + slot).to(torch.int32)
    yx = torch.stack([pids[:v2_cap] // sy, pids[:v2_cap] % sy - 1], 1)
    coords2 = torch.where(pvalid[:, None], yx, -1).to(torch.int32)
    return (ids2, coords2, pvalid, pfeats[:v2_cap].reshape(v2_cap, nz * c),
            pmask[:v2_cap])


def depillarize(ids2, pvalid, pfeats, pmask, shape, nz: int):
    """Dense-z pillars -> a voxel list of capacity V2 * nz in (y, x, z)
    order: (ids3 in sparse_ops' guard-banded yxz scheme, coords (V2 * nz,
    3) zyx, valid, feats (V2 * nz, C)); inactive cells stay as invalid
    rows with sentinel ids."""
    v2 = ids2.shape[0]
    c = pfeats.shape[1] // nz
    dev = ids2.device
    sx3, sy3 = yxz_strides(shape)
    i2 = ids2.long()
    y = i2 // _yx_stride(shape)
    x = i2 % _yx_stride(shape) - 1
    z = torch.arange(nz, device=dev)
    valid = pmask & pvalid[:, None]
    ids3 = y[:, None] * sy3 + (x[:, None] + 1) * sx3 + z[None, :] + 1
    flat_idx = torch.arange(v2 * nz, device=dev).reshape(v2, nz)
    ids3 = torch.where(valid, ids3, yxz_sentinel_start(shape) + flat_idx)
    coords = torch.stack([z[None, :].expand(v2, nz), y[:, None].expand(
        v2, nz), x[:, None].expand(v2, nz)], -1)
    coords = torch.where(valid[..., None], coords, -1)
    feats = pfeats.reshape(v2, nz, c)
    feats = torch.where(valid[..., None], feats, torch.zeros_like(feats))
    return (ids3.reshape(-1).to(torch.int32),
            coords.reshape(-1, 3).to(torch.int32), valid.reshape(-1),
            feats.reshape(-1, c))


def make_zband(w_tap, zc: int, stride: int = 1):
    """w_tap (3, Cin, Cout), the z taps dz = -1, 0, +1 of one 2D tap ->
    the banded chunk weight: output z-cell j of a chunk reads the padded
    input cells stride * j + {0, 1, 2}. Shape ((stride * zc + 3 - stride)
    * Cin, zc * Cout)."""
    _, cin, cout = w_tap.shape
    rows = stride * zc + 3 - stride
    wc = w_tap.new_zeros(rows, cin, zc, cout)
    for j in range(zc):
        for dz in range(3):
            wc[stride * j + dz, :, j] = w_tap[dz]
    return wc.reshape(rows * cin, zc * cout)


def split_taps(weights, kernel=(3, 3, 3)):
    """weights (27, Cin, Cout) in kernel_offsets' zyx order -> {(dy, dx):
    (3, Cin, Cout) stacked dz = -1, 0, +1}."""
    out = {}
    for k, (dz, dy, dx) in enumerate(kernel_offsets(kernel)):
        out.setdefault((int(dy), int(dx)), {})[int(dz)] = weights[k]
    return {key: torch.stack([v[-1], v[0], v[1]]) for key, v in out.items()}


def _align(ids2, pfeats, want, inb=None):
    """The rows of pfeats at the pillar ids `want` (zero where absent),
    with the hit mask."""
    v2 = ids2.shape[0]
    pos = torch.searchsorted(ids2, want.to(ids2.dtype))
    posc = torch.clamp(pos, max=v2 - 1)
    hit = (pos < v2) & (ids2[posc] == want)
    if inb is not None:
        hit = hit & inb
    return torch.where(hit[:, None], pfeats[posc],
                       torch.zeros((), dtype=pfeats.dtype,
                                   device=pfeats.device)), hit


def _banded(out, g, wc, chunks, zc, step, rows, cin, cout):
    """out (V, nzp * Cout) += every chunk's slice of the padded input g
    times the banded weight wc, in float32."""
    for ch in range(chunks):
        sl = g[:, ch * step * cin:(ch * step + rows) * cin]
        out[:, ch * zc * cout:(ch + 1) * zc * cout] += sl.float() @ wc


def zdense_subm(ids2, pfeats, pmask, pvalid, weights, shape, nz: int,
                cin: int, zc: int = 8):
    """Submanifold 3x3x3 conv over dense-z pillars. ids2 (V2,) ascending;
    pfeats (V2, nz * Cin); pmask (V2, nz); weights (27, Cin, Cout). Returns
    (V2, nz * Cout) float32, zero at inactive cells; z runs in chunks of
    zc cells."""
    v2 = ids2.shape[0]
    cout = weights.shape[2]
    taps = split_taps(weights)
    nzp = -(-nz // zc) * zc
    deltas = yx_offset_deltas(shape)
    out = torch.zeros(v2, nzp * cout, dtype=torch.float32,
                      device=pfeats.device)
    ti = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            g = pfeats if dy == 0 and dx == 0 else \
                _align(ids2, pfeats, ids2.long() + deltas[ti])[0]
            gp = F.pad(g.reshape(v2, nz, cin), (0, 0, 1, 1 + nzp - nz))
            _banded(out, gp.reshape(v2, -1),
                    make_zband(taps[(dy, dx)].float(), zc), nzp // zc, zc,
                    zc, zc + 2, cin, cout)
            ti += 1
    mask = (pmask & pvalid[:, None])[..., None]
    return (out[:, :nz * cout].reshape(v2, nz, cout) * mask).reshape(
        v2, nz * cout)


def zdense_downsample(ids2, coords2, pfeats, pmask, pvalid, weights,
                      in_shape, out_shape, nz_in: int, nz_out: int,
                      cin: int, v2_out_cap: int, zc: int = 4):
    """Strided (stride 2, kernel 3, padding 1) sparse conv over dense-z
    pillars. The output pillars are the 3x3 stride-2 max-pool of the input
    occupancy, the first v2_out_cap in (y, x) order; an output z-cell is
    active where any input cell of its stride-2 z window in any of its
    nine input pillars is. Returns (ids2_o, coords2_o, pvalid_o, pfeats_o
    (V2o, nz_out * Cout) float32, pmask_o (V2o, nz_out))."""
    v2 = ids2.shape[0]
    dev = pfeats.device
    cout = weights.shape[2]
    _, ny_i, nx_i = (int(s) for s in in_shape)
    _, ny_o, nx_o = (int(s) for s in out_shape)

    occ = torch.zeros(ny_i + 1, nx_i + 1, dtype=torch.float32, device=dev)
    iy = torch.where(pvalid, coords2[:, 0].long(), ny_i)
    ix = torch.where(pvalid, coords2[:, 1].long(), nx_i)
    occ[iy, ix] = 1.0
    pooled = F.max_pool2d(occ[None, None, :ny_i, :nx_i], 3, 2, 1)[0, 0]
    active = pooled.reshape(-1) > 0
    cells = torch.nonzero(active).flatten()[:v2_out_cap]
    num = cells.numel()
    out_pos = torch.zeros(v2_out_cap, dtype=torch.long, device=dev)
    out_pos[:num] = cells
    pvalid_o = torch.arange(v2_out_cap, device=dev) < num
    yo, xo = out_pos // nx_o, out_pos % nx_o
    coords2_o = torch.where(pvalid_o[:, None], torch.stack([yo, xo], 1),
                            -1).to(torch.int32)
    slot = torch.arange(v2_out_cap, device=dev)
    ids2_o = torch.where(pvalid_o, yo * _yx_stride(out_shape) + xo + 1,
                         yx_sentinel_start(out_shape) + slot).to(torch.int32)

    taps = split_taps(weights)
    nzop = -(-nz_out // zc) * zc
    need = 2 * nzop + 1
    out = torch.zeros(v2_out_cap, nzop * cout, dtype=torch.float32,
                      device=dev)
    zmask = torch.zeros(v2_out_cap, nz_in, dtype=torch.bool, device=dev)
    sy_i = _yx_stride(in_shape)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yi, xi = 2 * yo + dy, 2 * xo + dx
            inb = (yi >= 0) & (yi < ny_i) & (xi >= 0) & (xi < nx_i)
            g, hit = _align(ids2, pfeats, yi * sy_i + xi + 1, inb)
            zmask |= hit[:, None] & _align(ids2, pmask, yi * sy_i + xi + 1,
                                           inb)[0]
            gp = F.pad(g.reshape(v2_out_cap, nz_in, cin),
                       (0, 0, 1, max(0, need - nz_in - 1)))
            _banded(out, gp.reshape(v2_out_cap, -1),
                    make_zband(taps[(dy, dx)].float(), zc, stride=2),
                    nzop // zc, zc, 2 * zc, 2 * zc + 1, cin, cout)
    zp = F.pad(zmask.to(torch.uint8),
               (1, 1 + max(0, 2 * nz_out - nz_in - 1))).bool()
    pmask_o = torch.stack([zp[:, 2 * z:2 * z + 3].any(1)
                           for z in range(nz_out)], 1) & pvalid_o[:, None]
    out = out[:, :nz_out * cout].reshape(v2_out_cap, nz_out, cout) \
        * pmask_o[..., None]
    return (ids2_o, coords2_o, pvalid_o,
            out.reshape(v2_out_cap, nz_out * cout), pmask_o)
