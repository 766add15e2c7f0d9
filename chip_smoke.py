#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--batches 1 8] [--out details.json]

Phases (any failure exits non-zero and prints no result line):
  1. device — the card's name and power limit, torch/CUDA versions, and the
     nvcc build of the kernels from findnpropagate_torch/ops/csrc/ into
     build/kernels/ (with ptxas' register / shared-memory report);
  2. kernels — a batch-1 forward of the main path records the arguments of
     every launch of K1 (positions) and K2 (posgather conv); each recorded
     call is re-run through the kernel and through its plain PyTorch
     version on the card: K1 must be bit-equal, K2 within its bf16
     tolerance. Times are CUDA events after a warm-up;
  3. main path — TransFusion-LiDAR from
     tools/cfgs/nuscenes_models/transfusion_lidar.yaml at full width,
     random weights (init_random_, seed 0), 200k-point lidar_ring scenes,
     forward + post_process at each batch size: detections finite,
     sparse_window_overflow == 0, 6 K1 and 16 K2 launches per forward;
     ms/scan and scans/s (median of chained runs), actives per level, peak
     memory;
  4. reference — a narrow model on a cropped scene, on the card and on the
     CPU (plain versions, f32): same actives, outputs within bf16 error;
  5. a `kernels` JSON line, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of jax. Without CUDA, or without the port beside it, it
exits non-zero.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense tensor-core bf16
CUDA_CORE_OPS = 67e12            # f32 / int32 outside the tensor cores
CFG_FILE = "tools/cfgs/nuscenes_models/transfusion_lidar.yaml"
# K2 compares the kernel with its plain version at the same bf16 operand
# rounding; only the f32 summation order differs, so the error stays far
# below one bf16 step (2^-8 relative): allow 1e-3 of the output's scale.
K2_RTOL = 1e-3
REPLACES = {
    "positions": "findnpropagate_tpu/ops/pallas_posgather.py:75",
    "posgather_conv": "findnpropagate_tpu/ops/pallas_posgather.py:194",
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps, warm=1):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def data_cfg(num_scenes, cfg, pcr=None, voxel=None, max_voxels=None,
             max_points=None):
    """bench.py's synthetic nuScenes data config (lidar_ring, 200k raw
    points, x/y/z/intensity), optionally cropped for the reference phase."""
    caps = dict(cfg.DATA_CONFIG.CAPACITIES)
    if max_voxels:
        caps["MAX_VOXELS"] = max_voxels
    if max_points:
        caps["MAX_POINTS"] = max_points
    return {
        "POINT_CLOUD_RANGE": pcr or list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
        "SYNTHETIC": {"NUM_SCENES": num_scenes, "NUM_OBJECTS": 40,
                      "NUM_RAW_POINTS": 200000, "PATTERN": "lidar_ring"},
        "CAPACITIES": caps,
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z", "intensity"],
            "src_feature_list": ["x", "y", "z", "intensity"]},
        "DATA_PROCESSOR": [{"NAME": "transform_points_to_voxels",
                            "VOXEL_SIZE": voxel or [0.075, 0.075, 0.2]}],
    }


class Recorder:
    """Wraps a kernel wrapper of ops/posgather.py and keeps a copy of the
    arguments of every call."""

    def __init__(self, module, name, torch):
        self.module, self.name, self.torch = module, name, torch
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args, **kw):
            clone = lambda x: x.clone() if isinstance(  # noqa: E731
                x, self.torch.Tensor) else x
            self.calls.append(([clone(a) for a in args],
                               {k: clone(v) for k, v in kw.items()}))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def positions_bound(args):
    src, tgt, lo, tap_lo, has_real, gdeltas, block, span, use_tap = args
    g_n, vt = gdeltas.shape[0], tgt.shape[1]
    b = tgt.shape[0]
    nbytes = 4 * (src.numel() + tgt.numel() + lo.numel() + has_real.numel()
                  + (tap_lo.numel() if use_tap else 0) + gdeltas.numel()
                  + b * g_n * vt)
    ops = b * g_n * vt * math.ceil(math.log2(span + 1))
    return nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS


def conv_bound(tp, args, kw):
    (src, feats, tgt, pos, lo, has_real, gdeltas, w_flat, block,
     window) = args
    hits = sum(int(found.sum()) for _, found in tp.neighbour_probes(
        src, tgt, pos, lo, has_real, gdeltas, block, window))
    cin, cout = feats.shape[2], w_flat.shape[1]
    nbytes = (4 * (src.numel() + tgt.numel() + pos.numel() + lo.numel()
                   + has_real.numel() + feats.numel())
              + 2 * w_flat.numel() + 4 * tgt.numel() * cout
              + (8 * cout if kw.get("scale") is not None else 0))
    flops = 2 * cin * cout * hits
    return nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS, hits


def bound_entry(t_bytes, t_ops):
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, tp, pos_calls, conv_calls):
    """Kernel vs plain on every recorded call; returns per-call rows."""
    rows = []
    for i, (args, kw) in enumerate(pos_calls):
        out = tp.positions(*args, **kw)
        ref = tp.positions_plain(*args, **kw)
        torch.cuda.synchronize()
        err = int((out.long() - ref.long()).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"K1 call {i}: kernel != plain (max {err})")
        t_b, t_o = positions_bound(args)
        bound_ms, bound_by = bound_entry(t_b, t_o)
        rows.append({
            "name": "positions", "call": i, "vt": args[1].shape[1],
            "vs": args[0].shape[1], "span": args[7], "tap": args[8],
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: tp.positions(*args, **kw), 20),
            "plain_ms": cuda_ms(torch, lambda: tp.positions_plain(
                *args, **kw), 3),
            "bound_ms": bound_ms, "bound_by": bound_by})
    for i, (args, kw) in enumerate(conv_calls):
        out = tp.gather_conv(*args, **kw)
        ref = tp.posgather_conv_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = K2_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"K2 call {i}: max err {err} > {tol}")
        t_b, t_o, hits = conv_bound(tp, args, kw)
        bound_ms, bound_by = bound_entry(t_b, t_o)
        rows.append({
            "name": "posgather_conv", "call": i, "vt": args[2].shape[1],
            "vs": args[0].shape[1], "cin": args[1].shape[2],
            "cout": args[7].shape[1], "window": args[9],
            "epilogue": kw.get("scale") is not None, "hits": hits,
            "max_abs_err": err, "tolerance": tol,
            "ms": cuda_ms(torch, lambda: tp.gather_conv(*args, **kw), 10),
            "plain_ms": cuda_ms(torch, lambda: tp.posgather_conv_plain(
                *args, **kw), 3),
            "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def run_main_path(torch, det, tp, batch, b, reps):
    tp.reset_launches()
    out = det(batch)
    dets = det.post_process(out)
    torch.cuda.synchronize()
    launches = dict(tp.LAUNCHES)
    if launches != {"positions": 6, "posgather_conv": 16}:
        raise AssertionError(f"batch {b}: launches {launches}, want 6/16")
    ovf = int(out["sparse_window_overflow"])
    if ovf != 0:
        raise AssertionError(f"batch {b}: sparse_window_overflow {ovf}")
    for name in ("boxes", "scores"):
        t = getattr(dets, name)
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"batch {b}: non-finite {name}")
    if tuple(dets.boxes.shape) != (b, 200, 9):
        raise AssertionError(f"batch {b}: boxes {tuple(dets.boxes.shape)}")
    active = [int(c) // b for c in out["sparse_active_counts"]]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(reps + 2):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        det.post_process(det(batch))
        t1.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(t0.elapsed_time(t1))
    med = sorted(times)[len(times) // 2]
    return {"batch": b, "launches_per_forward": launches,
            "ms_per_batch": med, "ms_per_scan": med / b,
            "scans_per_s": 1e3 * b / med, "times_ms": times,
            "active_voxels_per_level": active,
            "detections_per_scan": [int(c) for c in dets.count],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def profile_forward(torch, det, batch, path):
    """Device time by kernel over one forward + post_process; returns the
    wall time, the summed device time of all kernels and their ratio."""
    from torch.profiler import ProfilerActivity, profile

    det.post_process(det(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.post_process(det(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" or "cuda" in str(
                  e.device_type).lower()]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / (wall * 1e3)}


def reference_phase(torch, cfg_mod, synth, models_mod, weights):
    """Narrow model, cropped scene: card (kernels, bf16) vs CPU (plain, f32)."""
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE))
    m = cfg.MODEL
    m.BACKBONE_3D.update({
        "MAX_VOXELS": 2048, "LEVEL_CAPACITIES": [2048, 2048, 2048, 1024,
                                                 1024],
        "WINDOWED_BLOCK": 512, "CHANNELS": [16, 16, 16, 16, 16],
        "OUT_CHANNELS": 16, "DENSE_DTYPE": "f32"})
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                          "NUM_UPSAMPLE_FILTERS": [16, 16]})
    m.DENSE_HEAD.update({"HIDDEN_CHANNEL": 32, "NUM_HEADS": 2,
                         "FFN_CHANNEL": 64, "NUM_PROPOSALS": 20})
    ds = synth.SyntheticDataset(cfg_mod.EDict(data_cfg(
        2, cfg, pcr=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0], voxel=[0.2, 0.2, 0.2],
        max_voxels=2048, max_points=40000)), cfg.CLASS_NAMES)
    batch = ds.batch(range(2))
    outs = {}
    for dev in ("cuda", "cpu"):
        det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds,
                                       device=dev)
        weights.init_random_(det, seed=1)
        outs[dev] = det({k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()})
    g, c = outs["cuda"], outs["cpu"]
    if not torch.equal(g["sparse_active_counts"].cpu(),
                       c["sparse_active_counts"]):
        raise AssertionError("reference: active counts differ")
    if int(g["sparse_window_overflow"]) or int(c["sparse_window_overflow"]):
        raise AssertionError("reference: overflow")
    errs = {}
    for key, a, b in (
            ("encoded_spconv_tensor", g["encoded_spconv_tensor"],
             c["encoded_spconv_tensor"]),
            ("dense_heatmap", g["transfusion_preds"]["dense_heatmap"],
             c["transfusion_preds"]["dense_heatmap"])):
        rel = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-12))
        errs[key] = rel
        # bf16 operands through 16 sparse convs: ~1e-2 relative at most
        if not rel < 3e-2:
            raise AssertionError(f"reference: {key} rel err {rel}")
    return errs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="write every measurement to this JSON file")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler kernel table of one "
                    "forward at the largest batch to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from findnpropagate_torch import config as cfg_mod
        from findnpropagate_torch import models as models_mod
        from findnpropagate_torch.datasets import synthetic as synth
        from findnpropagate_torch.ops import _build
        from findnpropagate_torch.ops import posgather as tp
        from findnpropagate_torch.ops import sparse_ops
        from findnpropagate_torch.utils import weights
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    report = {}
    # ---- 1. device + build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.build_all(["posgather"])
    _build.load("posgather")
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s (nvcc "
        f"{_build.BUILD_SECONDS.get('posgather', 0.0):.1f} s)")
    for line in _build.PTXAS_LOG.get("posgather", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE))
    nmax = max(max(args.batches), 2)
    ds = synth.SyntheticDataset(cfg_mod.EDict(data_cfg(nmax, cfg)),
                                cfg.CLASS_NAMES)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds)
    weights.init_random_(det, seed=0)
    batches = {b: {k: torch.from_numpy(v).cuda()
                   for k, v in ds.batch(range(b)).items()}
               for b in args.batches}

    # ---- 2. kernels vs plain, at the main path's own arguments
    with Recorder(tp, "positions", torch) as pos_rec, \
            Recorder(tp, "gather_conv", torch) as conv_rec:
        det.post_process(det(batches[min(args.batches)]))
        torch.cuda.synchronize()
        # K1's tap sub-window mode (not on the main path: the port ranks
        # over the union window) at L0, with the yaml's L0 tap window
        src = pos_rec.calls[0][0][0]
        s1 = det.backbone_3d.level_shapes[0]
        bb = cfg.MODEL.BACKBONE_3D
        tp.compute_positions(
            src, src, sparse_ops.yxz_offset_deltas((3, 3, 3), s1),
            int(bb.WINDOWED_BLOCK), int(bb.WINDOWED_WINDOW[0]),
            tap_window=int(bb.TAP_WINDOW[0]),
            sentinel_start=sparse_ops.yxz_sentinel_start(s1))
    rows = check_kernels(torch, tp, pos_rec.calls, conv_rec.calls)
    report["kernel_calls"] = rows
    for r in rows:
        shape = (f"vt={r['vt']} span={r['span']}" if r["name"] == "positions"
                 else f"vt={r['vt']} {r['cin']}->{r['cout']} "
                 f"epi={int(r['epilogue'])}")
        log(f"{r['name']:15s} call {r['call']:2d} {shape:28s} "
            f"err {r['max_abs_err']:.3g}  ms {r['ms']:.4f}  plain "
            f"{r['plain_ms']:.3f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")

    # ---- 3. main path
    report["main_path"] = []
    for b in args.batches:
        res = run_main_path(torch, det, tp, batches[b], b, args.reps)
        report["main_path"].append(res)
        log(f"main path batch {b}: {res['ms_per_scan']:.2f} ms/scan "
            f"{res['scans_per_s']:.2f} scans/s, launches "
            f"{res['launches_per_forward']}, active/level "
            f"{res['active_voxels_per_level']}, peak "
            f"{res['peak_mem_gb']:.2f} GiB")

    if args.profile:
        report["profile"] = profile_forward(
            torch, det, batches[max(args.batches)], args.profile)
        log(f"profile batch {max(args.batches)}: {report['profile']}")

    # ---- 4. reference on a small input
    report["reference_rel_err"] = reference_phase(torch, cfg_mod, synth,
                                                  models_mod, weights)
    log(f"reference (card vs CPU, narrow model): "
        f"{report['reference_rel_err']}")

    # ---- 5. result lines
    first_batch = report["main_path"][0]["launches_per_forward"]
    pick = {
        # K1 at L0 (first call); K2 at the L0 16->16 subm conv with the
        # fused epilogue (the first call is the 4->16 input conv)
        "positions": next(r for r in rows if r["name"] == "positions"),
        "posgather_conv": [r for r in rows
                           if r["name"] == "posgather_conv"][1],
    }
    kernels = []
    for name, r in pick.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "findnpropagate_torch/ops/csrc/posgather.cu",
            "replaces": REPLACES[name], "launches": first_batch[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "call": r["call"], "vt": r["vt"]})
    report["kernels"] = kernels
    report["device"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
