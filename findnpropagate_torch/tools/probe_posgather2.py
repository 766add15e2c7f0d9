"""Position-gather convs (K1 + K2) against the windowed conv: parity on
small scenes, and the positions prelude and its convs timed at an L0 level
of a real-size scene — the port of tools/probe_posgather2.py.

    python -m findnpropagate_torch.tools.probe_posgather2 [--mode cpu|gpu]
        [--device cuda|cpu] [--window 2048] [--reps 5]

The mode picks the work, named as the modes of tools/probe_posgather2.py;
--device picks where it runs, the card unless `--device cpu` is given (on
the CPU the kernels' plain versions run):
  * --mode cpu (the default), the parity run: on three small scenes
    (numpy seeds 0-2 at densities 0.15, 0.4 and 0.02 of a 9x40x40 grid,
    2048 rows) a 5 -> 7 submanifold conv through compute_positions +
    posgather_conv against the windowed conv's plain version on the CPU
    (block 512, window 1024):
    overflow 0 and the relative error below 2e-2 (the probe's own bound);
  * --mode gpu, the timing run: the L0 level of a batch-1 lidar_ring scene
    (bench.py's data config for transfusion_lidar.yaml, the port's
    voxelize_mean, ids sorted and padded to the block of 1024): the
    positions prelude alone (CUDA events around eager calls, and replays
    of a CUDA graph of the same calls: the prelude is one K1 launch with no
    host sync), with one 16 -> 16 conv, and with five chained convs (eager
    calls), and the relative error of the
    conv against K3 (windowed_conv) over the same window, which must stay
    below 1e-3 (both bf16 operands, f32 sums); on the CPU nothing is
    timed.
Exits non-zero on a failure, and without CUDA unless `--device cpu` is
given.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import posgather as tp
from ..ops import sparse_ops as so
from ..ops import windowed_sparse as ws
from ._common import Probe, device_of, fmt_ms, parser

ROOT = Path(__file__).resolve().parents[2]
CFG_FILE = ROOT / "tools/cfgs/nuscenes_models/transfusion_lidar.yaml"
L0_SHAPE = (41, 1440, 1440)


def small_scene(v_cap=2048, shape=(9, 40, 40), density=0.15, seed=0):
    """The probe's small scene: ids sorted (sentinels last), valid rows,
    features (0 on invalid rows)."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = shape
    n = int(nz * ny * nx * density)
    lin = rng.choice(nz * ny * nx, min(n, v_cap), replace=False)
    coords = np.full((1, v_cap, 3), -1, np.int32)
    coords[0, :len(lin)] = np.stack([lin % nz, (lin // nz) % ny,
                                     lin // (nz * ny)], 1)
    valid = torch.arange(v_cap)[None] < len(lin)
    ids = so.yxz_linear_ids(torch.from_numpy(coords), valid, shape)
    ids, order = torch.sort(ids, dim=1)
    valid = torch.gather(valid, 1, order)
    feats = torch.from_numpy(rng.randn(1, v_cap, 5).astype(np.float32)
                             * 0.3) * valid[..., None]
    return ids, valid, feats, shape


def rel_err(out, ref, valid):
    out, ref = out * valid[..., None], ref * valid[..., None]
    return float((out - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)


def parity(dev):
    """K1 + K2 on `dev` against the windowed conv's plain version (on
    the CPU, f32)."""
    rng = np.random.RandomState(1)
    ok = True
    for seed, density in [(0, 0.15), (1, 0.4), (2, 0.02)]:
        ids, valid, feats, shape = small_scene(seed=seed, density=density)
        deltas = so.yxz_offset_deltas((3, 3, 3), shape)
        sent = so.yxz_sentinel_start(shape)
        w = torch.from_numpy(rng.randn(27, 5, 7).astype(np.float32) * 0.2)
        ref, ovf_ref = ws.windowed_conv(ids, feats, ids, w, deltas,
                                        block=512, window=1024,
                                        sentinel_start=sent)
        ids_d = ids.to(dev)
        lp = tp.compute_positions(ids_d, ids_d, deltas, block=512,
                                  window=1024, sentinel_start=sent)
        out = tp.posgather_conv(ids_d, feats.to(dev), ids_d, w.to(dev), lp,
                                sentinel_start=sent).cpu()
        err = rel_err(out, ref, valid)
        good = int(lp.overflow.sum()) == 0 and int(ovf_ref.sum()) == 0 \
            and err < 2e-2
        ok &= good
        print(f"seed {seed} density {density}: ovf={int(lp.overflow.sum())} "
              f"(ref {int(ovf_ref.sum())}) rel_err={err:.2e} "
              f"{'OK' if good else 'WRONG'}", flush=True)
    print(f"parity on {dev.type}: {'OK' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


def l0_ids(dev):
    """Sorted L0 ids of scene 0 of bench.py's data config, padded to the
    block with ascending ids above the last."""
    from .. import config as cfg_mod
    from ..datasets import synthetic as synth
    from ..ops.voxelize import voxelize_mean

    cfg = cfg_mod.cfg_from_yaml_file(str(CFG_FILE))
    ds = synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(1, cfg)),
                                cfg.CLASS_NAMES, training=False)
    batch = ds.batch([0])
    vox = voxelize_mean(
        torch.from_numpy(batch["points"]).to(dev),
        torch.from_numpy(batch["points_mask"]).to(dev),
        ds.point_cloud_range, ds.voxel_size, ds.grid_size, ds.max_voxels,
        ds.max_points_per_voxel)
    ids = torch.sort(so.yxz_linear_ids(vox.coords, vox.voxel_mask,
                                       L0_SHAPE), dim=1)[0]
    pad = (-ids.shape[1]) % 1024
    if pad:
        ids = torch.cat([ids, ids[:, -1:] + 2 + torch.arange(
            pad, dtype=ids.dtype, device=dev)], dim=1)
    return ids.contiguous(), int(vox.voxel_mask.sum())


def gpu_bench(dev, window, reps):
    ids, n_real = l0_ids(dev)
    deltas = so.yxz_offset_deltas((3, 3, 3), L0_SHAPE)
    sent = so.yxz_sentinel_start(L0_SHAPE)
    rng = np.random.RandomState(0)
    c, block = 16, 1024
    w = torch.from_numpy(rng.randn(27, c, c).astype(np.float32) * 0.05).to(
        dev)
    feats = torch.from_numpy(rng.randn(1, ids.shape[1], c).astype(
        np.float32) * 0.1).to(dev)
    probe = Probe(dev, reps)

    def prelude():
        return tp.compute_positions(ids, ids, deltas, block=block,
                                    window=window, sentinel_start=sent)

    def convs(n):
        lp = prelude()
        x = feats
        for _ in range(n):
            x = tp.posgather_conv(ids, x, ids, w, lp, sentinel_start=sent)
        return x

    lp = prelude()
    print(f"L0 of a batch-1 lidar_ring scene: {n_real} voxels, Vt "
          f"{ids.shape[1]}, window {lp.window}, overflow "
          f"{int(lp.overflow.sum())}", flush=True)
    t_pos, d_pos = probe.time(prelude)
    t1 = probe.time(lambda: convs(1), graph=False)[0]
    t5 = probe.time(lambda: convs(5), graph=False)[0]
    print(f"positions prelude: {fmt_ms(t_pos)}  device {fmt_ms(d_pos)}",
          flush=True)
    print(f"positions + 1 conv: {fmt_ms(t1)}", flush=True)
    per = None if t5 is None else (t5 - t_pos) / 5
    print(f"positions + 5 convs: {fmt_ms(t5)} (per conv {fmt_ms(per)})",
          flush=True)
    out = tp.posgather_conv(ids, feats, ids, w, lp, sentinel_start=sent)
    ref, ovf = ws.windowed_conv(ids, feats, ids, w, deltas, block=block,
                                window=window, sentinel_start=sent)
    valid = ids < sent
    err = rel_err(out, ref, valid)
    good = err < 1e-3 and bool(torch.isfinite(out).all())
    print(f"vs windowed conv (K3): rel_err={err:.2e} (ovf ref "
          f"{int(ovf.sum())}, new {int(lp.overflow.sum())}) "
          f"{'OK' if good else 'WRONG'}", flush=True)
    return 0 if good else 1


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--mode", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--window", type=int, default=2048)
    ap.set_defaults(reps=5)
    args = ap.parse_args(argv)
    dev = device_of(args)
    if dev is None:
        return 2
    if args.mode == "cpu":
        return parity(dev)
    return gpu_bench(dev, args.window, args.reps)


if __name__ == "__main__":
    sys.exit(main())
