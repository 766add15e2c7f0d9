#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--batches 1 8] [--train-batch 4]
                          [--train-steps 3] [--out details.json]
                          [--profile table.txt]

Phases (any failure exits non-zero and prints no result line):
  1. device — the card's name and power limit, torch/CUDA versions, and the
     nvcc build of the kernels from findnpropagate_torch/ops/csrc/ into
     build/kernels/ (with ptxas' register / shared-memory report; a
     register spill in the K2 or K4 kernel fails the run);
  2. kernels — synthetic corner cases of K2 and K4 at full channel widths
     (a dense cube where all 27 neighbours hit, a window too small, blocks
     of sentinels at the end, a dead block in the middle, Cout 10 and 3,
     Cin 4, batch 1 and 4) against their plain versions; then a batch-1
     forward of the main path records the arguments of every launch of K1
     (positions) and K2 (posgather conv); each recorded call is re-run
     through the kernel and through its plain PyTorch version on the card:
     K1 must be bit-equal, K2 within its tolerance. Times are CUDA events
     after a warm-up, around a loop of eager wrapper calls (`ms`) and, for
     K2, around replays of a CUDA graph of the same calls (`device_ms`: at
     batch 1 the eager loop is bound by the host's launch work);
  3. main path — TransFusion-LiDAR from
     tools/cfgs/nuscenes_models/transfusion_lidar.yaml at full width,
     random weights (init_random_, seed 0), 200k-point lidar_ring scenes,
     forward + post_process at each batch size: detections finite,
     sparse_window_overflow == 0, 6 K1 and 16 K2 launches per forward;
     ms/scan and scans/s (median of chained runs), actives per level, peak
     memory;
  4. reference — a narrow model on a cropped scene, on the card and on the
     CPU (plain versions, f32): same actives, outputs within bf16 error;
  5. training path — the same yaml at full width in training mode, batch 4
     (BATCH_SIZE_PER_GPU) of training scenes with their 40 boxes, adam at
     lr 1e-4 with clip 10 (bench.py's optimizer): one warm-up step, then
     timed steps at accum_steps=1 and one at accum_steps=2: finite loss and
     gradient norm, sparse_window_overflow == 0, matched ground truths > 0,
     parameters changed, and per step 3 K1, 13 + 12 K2, 3 + 3 K3 and 16 K4
     launches; ms/step, scans/s, the host time of the Hungarian matching,
     and the peak memory of the timed steps alone (counted from after the
     warm-up). One more step, untimed, has the arguments of its K1, K2
     (forward and backward), K3 (windowed conv, forward and transposed) and
     K4 (weight gradient) launches recorded. Last, one step at batch 1
     with SUBM_IMPL: pallas (every sparse conv through K3 and K4) against a
     posgather-mode step on the same scene and weights: loss within 1e-3,
     overflow 0, 0 K1, 0 K2, 16 + 15 K3 and 16 K4 launches;
  6. training kernels — every recorded call is re-run through the kernel
     and through its plain PyTorch version on the card (K2, K3, K4 sample
     by sample): K1 at batch 4 bit-equal, the others within the stated
     tolerance; times as in phase 2;
  7. pallas-mode forward — a batch-1 eval forward with SUBM_IMPL: pallas
     (every sparse conv through K3 with the fused scale/shift/ReLU/sentinel
     epilogue): each of its 16 K3 launches against the plain version with
     the same epilogue, and the forward against the posgather forward on
     the same weights, within bf16 error;
  8. a `kernels` JSON line, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of jax. Without CUDA, or without the port beside it, it
exits non-zero.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense tensor-core bf16
CUDA_CORE_OPS = 67e12            # f32 / int32 outside the tensor cores
CFG_FILE = "tools/cfgs/nuscenes_models/transfusion_lidar.yaml"
# K2 compares the kernel with its plain version at the same bf16 operand
# rounding. The tensor cores add the 27*Cin f32 products of an output in
# another order (16 at a time, group by group) than the plain matmul, so
# the two are no longer bit-equal, but the error stays far below one bf16
# step (2^-8 relative): allow 1e-3 of the output's scale.
K2_RTOL = 1e-3
# K3 is held the same way (bf16 operands equal on both sides, f32 sums of
# 27*Cin products in another order). K4 sums up to 4 x 131072 targets per
# output in f32, 16 at a time on the tensor cores, per chunk of targets and
# then over the chunks, where the plain version sums sample by sample: allow
# 2e-3 of the output's scale.
K3_RTOL = 1e-3
K4_RTOL = 2e-3
# One training step in SUBM_IMPL: pallas mode against posgather mode: the
# same bf16 products, f32 sums in another tap order through 13 submanifold
# convs, batch-statistic BN and the head: the losses agree to 1e-3.
PALLAS_TRAIN_RTOL = 1e-3
PALLAS_TRAIN_LAUNCHES = {"positions": 0, "posgather_conv": 0,
                         "windowed_conv": 31, "windowed_dw": 16}
TRAIN_OPT = {"OPTIMIZER": "adam", "LR": 1e-4, "WEIGHT_DECAY": 0.0,
             "GRAD_NORM_CLIP": 10.0}
TRAIN_LAUNCHES = {"positions": 3, "posgather_conv": 25, "windowed_conv": 6,
                  "windowed_dw": 16}
SOURCES = {
    "positions": "findnpropagate_torch/ops/csrc/posgather.cu",
    "posgather_conv": "findnpropagate_torch/ops/csrc/posgather.cu",
    "windowed_conv": "findnpropagate_torch/ops/csrc/windowed_sparse.cu",
    "windowed_dw": "findnpropagate_torch/ops/csrc/windowed_sparse.cu",
}
REPLACES = {
    "positions": "findnpropagate_tpu/ops/pallas_posgather.py:75",
    "posgather_conv": "findnpropagate_tpu/ops/pallas_posgather.py:194",
    "windowed_conv": "findnpropagate_tpu/ops/pallas_sparse.py:39",
    "windowed_dw": "findnpropagate_tpu/ops/pallas_sparse.py:285",
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


def graph_ms(torch, fn, reps):
    """Device time of fn per call: fn captured once into a CUDA graph and
    replayed, so the host's launch work (a few small PyTorch operations
    around each kernel) does not bound the measurement as it does in a loop
    of eager calls at small batch."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    return cuda_ms(torch, graph.replay, 3) / reps


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
        "DATA_PROCESSOR": [
            {"NAME": "mask_points_and_boxes_outside_range",
             "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "transform_points_to_voxels",
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


def corner_scene(torch, so, rng, shape, n_active, cap, batch, cin):
    """`batch` samples of n_active random cells of a small grid (all of
    them: a dense cube), sorted by id and padded to `cap` rows with
    sentinels; features are zero on the padding."""
    nz, ny, nx = shape
    coords = np.full((batch, cap, 3), -1, np.int32)
    for i in range(batch):
        lin = rng.choice(nz * ny * nx, n_active, replace=False)
        coords[i, :n_active] = np.stack(
            [lin % nz, (lin // nz) % ny, lin // (nz * ny)], 1)
    coords = torch.from_numpy(coords).cuda()
    valid = torch.arange(cap, device="cuda")[None, :].expand(batch, -1) \
        < n_active
    ids, order = torch.sort(so.yxz_linear_ids(coords, valid, shape), dim=1)
    feats = torch.from_numpy(rng.standard_normal(
        (batch, cap, cin)).astype("float32")).cuda()
    feats = feats * (ids < so.yxz_sentinel_start(shape))[..., None]
    return ids.contiguous(), feats


CORNERS = [
    # name, grid, actives, rows, batch, Cin, Cout, window, epilogue
    ("dense cube, 27 hits", (8, 16, 16), 2048, 2048, 1, 64, 128, 4096, True),
    ("window too small", (9, 24, 24), 2000, 2048, 1, 16, 16, 512, True),
    ("sentinel blocks at the end", (9, 40, 40), 1500, 4096, 4, 32, 64, 4096,
     True),
    ("dead block in the middle", (9, 40, 40), 3000, 4096, 1, 32, 32, 4096,
     False),
    ("Cout 10", (9, 40, 40), 1800, 2048, 1, 16, 10, 4096, False),
    ("Cout 3, batch 4", (9, 40, 40), 1800, 2048, 4, 64, 3, 4096, True),
    ("Cin 4", (9, 40, 40), 1800, 2048, 1, 4, 16, 4096, False),
]


def corner_phase(torch, tp, ws, so, block=1024):
    """K2 and K4 against their plain versions on synthetic cases (numpy
    seed 0) that the recorded launches of the paths do not reach."""
    rng = np.random.RandomState(0)
    rows = []
    for name, shape, n, cap, b, cin, cout, window, epi in CORNERS:
        ids, feats = corner_scene(torch, so, rng, shape, n, cap, b, cin)
        deltas = so.yxz_offset_deltas((3, 3, 3), shape)
        sent = so.yxz_sentinel_start(shape)
        w = torch.from_numpy(rng.standard_normal(
            (27, cin, cout)).astype("float32") * 0.1).cuda()
        kw = {}
        if epi:
            kw = dict(scale=torch.from_numpy(rng.uniform(
                0.5, 1.5, cout).astype("float32")).cuda(),
                shift=torch.from_numpy(rng.standard_normal(
                    cout).astype("float32")).cuda(), relu=True)
        lp = tp.compute_positions(ids, ids, deltas, block=block,
                                  window=window, sentinel_start=sent)
        if name == "dead block in the middle":
            hr = lp.has_real.clone()
            hr[:, 1] = 0
            lp = dataclasses.replace(lp, has_real=hr)
        with Recorder(tp, "gather_conv", torch) as rec:
            out = tp.posgather_conv(ids, feats, ids, w, lp,
                                    sentinel_start=sent, **kw)
        (args, ckw), = rec.calls
        ref = tp.posgather_conv_plain(*args, **ckw)[..., :cout]
        torch.cuda.synchronize()
        err2 = float((out - ref).abs().max())
        tol2 = K2_RTOL * max(float(ref.abs().max()), 1e-3)
        hits = torch.stack([f for _, f in tp.neighbour_probes(
            args[0], *args[2:7], *args[8:10])]).sum(dim=0).sum(dim=1)
        ovf = int(lp.overflow.sum())
        dead = int((lp.has_real == 0).sum())
        if not (err2 <= tol2 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"corner {name}: K2 err {err2} > {tol2}")
        if name.startswith("dense cube") and int(hits.max()) != 27:
            raise AssertionError(f"corner {name}: at most {int(hits.max())} "
                                 "of 27 neighbours hit")
        if (name == "window too small") != (ovf > 0):
            raise AssertionError(f"corner {name}: overflow {ovf}")
        if name in ("sentinel blocks at the end",
                    "dead block in the middle") and not (
                dead > 0 and bool((out.reshape(
                    b, -1, block, cout)[lp.has_real == 0] == 0).all())):
            raise AssertionError(f"corner {name}: {dead} dead blocks, or "
                                 "their rows are not zero")

        g = torch.from_numpy(rng.standard_normal(
            (b, cap, cout)).astype("float32")).cuda()
        with Recorder(ws, "dw_kernel", torch) as rec:
            dw = ws.windowed_dw(ids, feats, ids, g, deltas, block=block,
                                window=window)
        (args, ckw), = rec.calls
        ref = ws.windowed_dw_plain(*args,
                                   compute_dtype=ckw["compute_dtype"])
        torch.cuda.synchronize()
        err4 = float((dw - ref).abs().max())
        tol4 = K4_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (tuple(dw.shape) == (27, cin, cout) and err4 <= tol4
                and bool(torch.isfinite(dw).all())):
            raise AssertionError(f"corner {name}: K4 err {err4} > {tol4}")
        if not torch.equal(dw, ws.dw_kernel(*args, **ckw)):
            raise AssertionError(f"corner {name}: K4 differs between runs")
        rows.append({"case": name, "batch": b, "cin": cin, "cout": cout,
                     "overflow": ovf, "dead_blocks": dead,
                     "max_hits": int(hits.max()), "k2_err": err2,
                     "k2_tol": tol2, "k4_err": err4, "k4_tol": tol4})
        log(f"corner {name:28s} batch {b} {cin}->{cout} overflow {ovf} "
            f"dead blocks {dead} max hits {int(hits.max())}: K2 err "
            f"{err2:.3g} (tol {tol2:.3g}), K4 err {err4:.3g} (tol "
            f"{tol4:.3g})")
    return rows


def check_positions(torch, tp, pos_calls, label=""):
    """K1 vs plain, bit for bit, on every recorded call; per-call rows."""
    rows = []
    for i, (args, kw) in enumerate(pos_calls):
        out = tp.positions(*args, **kw)
        ref = tp.positions_plain(*args, **kw)
        torch.cuda.synchronize()
        err = int((out.long() - ref.long()).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"{label}K1 call {i}: kernel != plain "
                                 f"(max {err})")
        t_b, t_o = positions_bound(args)
        bound_ms, bound_by = bound_entry(t_b, t_o)
        rows.append({
            "name": "positions", "call": i, "batch": args[1].shape[0],
            "vt": args[1].shape[1], "vs": args[0].shape[1], "span": args[7],
            "tap": args[8], "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: tp.positions(*args, **kw), 20),
            "plain_ms": cuda_ms(torch, lambda: tp.positions_plain(
                *args, **kw), 3),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    return rows


def check_kernels(torch, tp, pos_calls, conv_calls):
    """Kernel vs plain on every recorded call; returns per-call rows."""
    rows = check_positions(torch, tp, pos_calls)
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
            "device_ms": graph_ms(
                torch, lambda: tp.gather_conv(*args, **kw), 10),
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


# ------------------------------------------------------------- training path


def per_sample(fn, args, kw, batched, reduce):
    """Run a plain version one sample at a time (its gather buffers are
    (K, Vt, Cin) floats per sample) and join the results."""
    b = args[batched[0]].shape[0]
    outs = []
    for i in range(b):
        a = [x[i:i + 1] if j in batched else x for j, x in enumerate(args)]
        outs.append(fn(*a, **kw))
    return reduce(outs)


def windowed_hits(torch, ws, src, tgt, lo, deltas, block, window):
    return sum(int(ws.neighbour_rows(src[i:i + 1], tgt[i:i + 1],
                                     lo[i:i + 1], deltas, block,
                                     window)[1].sum())
               for i in range(src.shape[0]))


def check_windowed_conv(torch, ws, k3_calls, direction, label=""):
    """K3 vs plain (sample by sample, with the call's own epilogue
    arguments) on every recorded call; per-call rows."""
    rows = []
    cat = lambda outs: torch.cat(outs, dim=0)          # noqa: E731
    for i, (args, kw) in enumerate(k3_calls):
        src, feats, tgt, lo, deltas, w_flat, block, window = args
        out = ws.conv_kernel(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            ws.windowed_conv_plain, args, kw, (0, 1, 2, 3), cat)
        ref = plain()
        err = float((out - ref).abs().max())
        tol = K3_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"{label}K3 call {i}: err {err} > {tol}")
        hits = windowed_hits(torch, ws, src, tgt, lo, deltas, block, window)
        cin, cout = feats.shape[2], w_flat.shape[1]
        epilogue = kw.get("scale") is not None
        nbytes = (4 * (src.numel() + tgt.numel() + lo.numel()
                       + deltas.numel() + feats.numel())
                  + 2 * w_flat.numel() + 4 * tgt.numel() * cout
                  + (8 * cout if epilogue else 0))
        bound_ms, bound_by = bound_entry(nbytes / HBM_BYTES_PER_S,
                                         2 * cin * cout * hits / BF16_FLOPS)
        rows.append({
            "name": "windowed_conv", "call": i, "direction": direction(i),
            "batch": tgt.shape[0], "vt": tgt.shape[1], "vs": src.shape[1],
            "cin": cin, "cout": cout, "window": window,
            "epilogue": epilogue, "relu": bool(kw.get("relu")), "hits": hits,
            "max_abs_err": err, "tolerance": tol,
            "ms": cuda_ms(torch, lambda: ws.conv_kernel(*args, **kw), 5),
            "plain_ms": cuda_ms(torch, plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    return rows


def check_train_kernels(torch, tp, ws, k2_calls, k3_calls, k4_calls):
    """Every K2 / K3 / K4 launch of one training step against its plain
    version at the recorded arguments; returns per-call rows."""
    rows = []
    cat = lambda outs: torch.cat(outs, dim=0)          # noqa: E731
    for i, (args, kw) in enumerate(k2_calls):
        out = tp.gather_conv(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            tp.posgather_conv_plain, args, kw, (0, 1, 2, 3, 4, 5), cat)
        ref = plain()
        err = float((out - ref).abs().max())
        tol = K2_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"train K2 call {i}: err {err} > {tol}")
        t_b, t_o, hits = conv_bound(tp, args, kw)
        bound_ms, bound_by = bound_entry(t_b, t_o)
        rows.append({
            "name": "posgather_conv", "call": i,
            "direction": "forward" if i < 13 else "backward",
            "vt": args[2].shape[1], "vs": args[0].shape[1],
            "cin": args[1].shape[2], "cout": args[7].shape[1],
            "hits": hits, "max_abs_err": err, "tolerance": tol,
            "ms": cuda_ms(torch, lambda: tp.gather_conv(*args, **kw), 5),
            "plain_ms": cuda_ms(torch, plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    rows += check_windowed_conv(
        torch, ws, k3_calls,
        lambda i: "forward" if i < 3 else "transposed", "train ")
    for i, (args, kw) in enumerate(k4_calls):
        src, feats, tgt, g, lo, deltas, block, window = args
        out = ws.dw_kernel(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            ws.windowed_dw_plain, args,
            {"compute_dtype": kw["compute_dtype"]}, (0, 1, 2, 3, 4),
            lambda outs: torch.stack(outs).sum(dim=0))
        ref = plain()
        err = float((out - ref).abs().max())
        tol = K4_RTOL * max(float(ref.abs().max()), 1e-3)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"K4 call {i}: err {err} > {tol}")
        if not torch.equal(out, ws.dw_kernel(*args, **kw)):
            raise AssertionError(f"K4 call {i}: two runs differ")
        hits = windowed_hits(torch, ws, src, tgt, lo, deltas, block, window)
        cin, cout = feats.shape[2], g.shape[2]
        nbytes = 4 * (src.numel() + tgt.numel() + lo.numel()
                      + deltas.numel() + feats.numel() + g.numel()
                      + deltas.numel() * cin * cout)
        bound_ms, bound_by = bound_entry(nbytes / HBM_BYTES_PER_S,
                                         2 * cin * cout * hits / BF16_FLOPS)
        rows.append({
            "name": "windowed_dw", "call": i, "vt": tgt.shape[1],
            "vs": src.shape[1], "cin": cin, "cout": cout, "window": window,
            "hits": hits, "max_abs_err": err, "tolerance": tol,
            "ms": cuda_ms(torch, lambda: ws.dw_kernel(*args, **kw), 5),
            "plain_ms": cuda_ms(torch, plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    return rows


class HostTimer:
    """Adds up the host seconds spent inside module.name."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.seconds = 0.0

    def __enter__(self):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.orig(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def launches_now(tp, ws):
    return {**tp.LAUNCHES, **ws.LAUNCHES}


def run_train_step(torch, step, batch, tp, ws, lap, accum, want=None):
    """One optimizer step with the launch counts set to 0 just before and
    read just after; checks what a healthy step must show (`want`: the
    launch counts of one pass, the posgather mode's by default)."""
    tp.reset_launches()
    ws.reset_launches()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with HostTimer(lap, "_solve_one") as match:
        t0.record()
        metrics = step(batch)
        t1.record()
        torch.cuda.synchronize()
    launches = launches_now(tp, ws)
    want = {k: v * accum for k, v in (want or TRAIN_LAUNCHES).items()}
    if launches != want:
        raise AssertionError(f"train step: launches {launches}, want {want}")
    m = {k: float(v) for k, v in metrics.items()}
    if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            and m["grad_norm"] > 0):
        raise AssertionError(f"train step: loss {m['loss']} grad_norm "
                             f"{m['grad_norm']}")
    if m["sparse_window_overflow"] != 0:
        raise AssertionError("train step: sparse_window_overflow "
                             f"{m['sparse_window_overflow']}")
    matched = sum(v for k, v in m.items() if k.endswith("_matches"))
    if not matched > 0:
        raise AssertionError("train step: no ground truth was matched")
    return {"ms": t0.elapsed_time(t1), "loss": m["loss"],
            "grad_norm": m["grad_norm"], "matched": matched,
            "matching_host_ms": match.seconds * 1e3, "launches": launches}


def profile_train(torch, step, batch, path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
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


def training_phase(torch, mods, cfg, args, report):
    """Phases 5 and 6; returns the per-call rows of the training kernels."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    b = args.train_batch
    ds = synth.SyntheticDataset(cfg_mod.EDict(data_cfg(max(b, 2), cfg)),
                                cfg.CLASS_NAMES, training=True)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds)
    weights.init_random_(det, seed=0)
    det.train()
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.batch(range(b)).items()}
    n_gt = [int(c) for c in (batch["gt_boxes"][..., -1] > 0).sum(dim=1)]
    tx, _ = optimization.build_optimizer(det.parameters(), TRAIN_OPT, 1000)
    step1 = trainer.make_train_step(det, tx, accum_steps=1)
    before = [p.detach().clone() for p in det.parameters()]

    warm = run_train_step(torch, step1, batch, tp, ws, lap, 1)
    log(f"train warm-up step: {warm['ms']:.1f} ms, loss {warm['loss']:.4f}, "
        f"grad norm {warm['grad_norm']:.4f}, matched {warm['matched']:.0f} "
        f"of {sum(n_gt)} boxes, launches {warm['launches']}")
    changed = sum(bool((p.detach() != q).any())
                  for p, q in zip(det.parameters(), before))
    if changed < 0.9 * len(before):
        raise AssertionError(f"train step: only {changed} of {len(before)} "
                             "parameter tensors changed")
    del before

    # the peak of the timed steps alone: model, Adam state, batch and one
    # step's activations; nothing of the kernel checks is alive yet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = [run_train_step(torch, step1, batch, tp, ws, lap, 1)
             for _ in range(args.train_steps)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(s["ms"] for s in steps)[len(steps) // 2]
    step2 = trainer.make_train_step(det, tx, accum_steps=2)
    run_train_step(torch, step2, batch, tp, ws, lap, 2)      # warm shapes
    acc = run_train_step(torch, step2, batch, tp, ws, lap, 2)
    report["train"] = {
        "batch": b, "gt_boxes_per_scene": n_gt, "warm_up": warm,
        "steps": steps, "ms_per_step": med, "scans_per_s": 1e3 * b / med,
        "matching_host_ms": sorted(s["matching_host_ms"]
                                   for s in steps)[len(steps) // 2],
        "peak_mem_gb": peak, "accum2": acc, "updates": tx.count}
    log(f"train batch {b}: {med:.1f} ms/step, {1e3 * b / med:.2f} scans/s, "
        f"steps {[round(s['ms'], 1) for s in steps]}, loss "
        f"{[round(s['loss'], 4) for s in steps]}, matching on the host "
        f"{report['train']['matching_host_ms']:.1f} ms/step, peak "
        f"{peak:.2f} GiB; accum_steps=2: {acc['ms']:.1f} ms/step, launches "
        f"{acc['launches']}")
    if args.profile:
        report["train_profile"] = profile_train(
            torch, step1, batch, str(args.profile) + ".train.txt")
        log(f"profile train step: {report['train_profile']}")

    # one last step, untimed and after the profiled one, whose kernel
    # arguments are kept for phase 6
    with Recorder(tp, "positions", torch) as k1_rec, \
            Recorder(tp, "gather_conv", torch) as k2_rec, \
            Recorder(ws, "conv_kernel", torch) as k3_rec, \
            Recorder(ws, "dw_kernel", torch) as k4_rec:
        run_train_step(torch, step1, batch, tp, ws, lap, 1)

    del det, tx, step1, step2
    torch.cuda.empty_cache()
    pallas_train_phase(torch, mods, cfg, report)
    torch.cuda.empty_cache()
    rows = check_positions(torch, tp, k1_rec.calls, "train ")
    for r in rows:
        log(f"positions       call {r['call']:2d} batch {r['batch']} "
            f"vt={r['vt']} span={r['span']} err {r['max_abs_err']}  ms "
            f"{r['ms']:.4f}  plain {r['plain_ms']:.3f}  bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    conv_rows = check_train_kernels(torch, tp, ws, k2_rec.calls,
                                    k3_rec.calls, k4_rec.calls)
    log_conv_rows(conv_rows)
    return rows + conv_rows


def pallas_train_phase(torch, mods, cfg, report):
    """One training step at batch 1 in SUBM_IMPL: pallas mode (13
    submanifold and 3 strided convs forward through K3, 12 + 3 transposed,
    16 weight gradients through K4) beside a posgather-mode step on the same
    scene and weights: its own launch counts, overflow 0, and the same loss
    within PALLAS_TRAIN_RTOL."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    ds = synth.SyntheticDataset(cfg_mod.EDict(data_cfg(2, cfg)),
                                cfg.CLASS_NAMES, training=True)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.batch(range(1)).items()}
    res = {}
    for impl in ("posgather", "pallas"):
        mcfg = copy.deepcopy(cfg.MODEL)
        mcfg.BACKBONE_3D["SUBM_IMPL"] = impl
        det = models_mod.build_network(mcfg, 10, ds)
        weights.init_random_(det, seed=0)
        det.train()
        tx, _ = optimization.build_optimizer(det.parameters(), TRAIN_OPT,
                                             1000)
        step = trainer.make_train_step(det, tx, accum_steps=1)
        res[impl] = run_train_step(
            torch, step, batch, tp, ws, lap, 1,
            want=PALLAS_TRAIN_LAUNCHES if impl == "pallas" else None)
        del det, tx, step
    a, b = res["pallas"]["loss"], res["posgather"]["loss"]
    rel = abs(a - b) / max(abs(b), 1e-12)
    report["pallas_train"] = {"batch": 1, "pallas": res["pallas"],
                              "posgather": res["posgather"],
                              "loss_rel_diff": rel}
    log(f"train step, SUBM_IMPL pallas, batch 1: loss {a:.4f} (posgather "
        f"{b:.4f}, rel diff {rel:.3g}), {res['pallas']['ms']:.1f} ms "
        f"(posgather {res['posgather']['ms']:.1f} ms, both first steps), "
        f"launches {res['pallas']['launches']}")
    if not rel <= PALLAS_TRAIN_RTOL:
        raise AssertionError(f"pallas-mode training loss {a} vs posgather "
                             f"{b}: rel diff {rel}")


def log_conv_rows(rows):
    for r in rows:
        log(f"{r['name']:15s} call {r['call']:2d} "
            f"{r.get('direction', ''):10s} vt={r['vt']} "
            f"{r['cin']}->{r['cout']} hits {r['hits']} err "
            f"{r['max_abs_err']:.3g}  ms {r['ms']:.4f}  plain "
            f"{r['plain_ms']:.3f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")


def pallas_phase(torch, models_mod, cfg, ds, det, batch, tp, ws):
    """Phase 7: SUBM_IMPL pallas (K3 + fused epilogue everywhere), batch 1:
    every K3 launch against its plain version with the same epilogue, and
    the forward against the posgather forward on the same weights. Returns
    (errors, per-call rows)."""
    pcfg = copy.deepcopy(cfg.MODEL)
    pcfg.BACKBONE_3D["SUBM_IMPL"] = "pallas"
    pdet = models_mod.build_network(pcfg, 10, ds)
    pdet.load_state_dict(det.state_dict())
    # every sparse conv's output, in call order, of both modes
    backbone_cls = type(det.backbone_3d)
    orig, convs = backbone_cls._sparse_conv, {}

    def keep(self, *a, **kw):
        y = orig(self, *a, **kw)
        convs.setdefault(self.impl, []).append(y)
        return y

    backbone_cls._sparse_conv = keep
    try:
        ref = det(batch)
        ws.reset_launches()
        tp.reset_launches()
        with Recorder(ws, "conv_kernel", torch) as k3_rec:
            out = pdet(batch)
        torch.cuda.synchronize()
    finally:
        backbone_cls._sparse_conv = orig
    launches = launches_now(tp, ws)
    if launches != {"positions": 0, "posgather_conv": 0,
                    "windowed_conv": 16, "windowed_dw": 0}:
        raise AssertionError(f"pallas mode: launches {launches}")
    if int(out["sparse_window_overflow"]) != 0:
        raise AssertionError("pallas mode: overflow")
    if not all(kw.get("scale") is not None and kw.get("sentinel") is not None
               for _, kw in k3_rec.calls):
        raise AssertionError("pallas mode: a K3 launch had no epilogue")
    rows = check_windowed_conv(torch, ws, k3_rec.calls,
                               lambda i: "eval epilogue", "pallas mode ")
    worst = 0.0
    for i, (a, b) in enumerate(zip(convs["pallas"], convs["posgather"])):
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
        worst = max(worst, rel)
        # same bf16 products, f32 sums in another tap order
        if not rel < 1e-3:
            raise AssertionError(f"pallas mode: conv {i} rel err {rel}")
    errs = {"sparse_convs_worst_max_rel": worst, "sparse_convs": len(
        convs["pallas"])}
    for key, a, b in (
            ("encoded_spconv_tensor", out["encoded_spconv_tensor"],
             ref["encoded_spconv_tensor"]),
            ("dense_heatmap", out["transfusion_preds"]["dense_heatmap"],
             ref["transfusion_preds"]["dense_heatmap"])):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-12))
        errs[key] = rel
        # after the bf16 dense tail the two mostly round to the same values
        if not rel < 1e-2:
            raise AssertionError(f"pallas mode: {key} rel err {rel}")
    return errs, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--train-batch", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=3,
                    help="timed optimizer steps after the warm-up")
    ap.add_argument("--out", default=None,
                    help="write every measurement to this JSON file")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler kernel table of one "
                    "forward at the largest batch to this file, and of "
                    "one training step to <file>.train.txt")
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
        from findnpropagate_torch.ops import _build, lap
        from findnpropagate_torch.ops import posgather as tp
        from findnpropagate_torch.ops import sparse_ops
        from findnpropagate_torch.ops import windowed_sparse as ws
        from findnpropagate_torch.runtime import optimization, trainer
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
    sources = ["posgather", "windowed_sparse"]
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s (nvcc, in parallel: "
        + ", ".join(f"{n} {_build.BUILD_SECONDS.get(n, 0.0):.1f} s"
                    for n in sources) + ")")
    for name in sources:
        for line in _build.PTXAS_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas:", line.strip())
        # posgather.cu's conv_kernel is K2, windowed_dw_kernel is K4
        spilled = {fn: n for fn, n in _build.spills(
            _build.PTXAS_LOG.get(name, "")).items()
            if n and ("windowed_dw_kernel" in fn or (
                name == "posgather" and "conv_kernel" in fn))}
        if spilled:
            raise AssertionError(f"register spills in {name}: {spilled}")

    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE))
    nmax = max(max(args.batches), 2)
    ds = synth.SyntheticDataset(cfg_mod.EDict(data_cfg(nmax, cfg)),
                                cfg.CLASS_NAMES)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds)
    weights.init_random_(det, seed=0)
    batches = {b: {k: torch.from_numpy(v).cuda()
                   for k, v in ds.batch(range(b)).items()}
               for b in args.batches}

    # ---- 2. kernels vs plain: corner cases, then the main path's own
    # arguments
    report["corner_cases"] = corner_phase(torch, tp, ws, sparse_ops)
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
        dev = f" (device {r['device_ms']:.4f})" if "device_ms" in r else ""
        log(f"{r['name']:15s} call {r['call']:2d} {shape:28s} "
            f"err {r['max_abs_err']:.3g}  ms {r['ms']:.4f}{dev}  plain "
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

    # ---- 5, 6. training path and its kernels
    mods = (cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization,
            trainer)
    train_rows = training_phase(torch, mods, cfg, args, report)
    report["train_kernel_calls"] = train_rows

    # ---- 7. pallas-mode forward
    report["pallas_mode_rel_err"], report["pallas_kernel_calls"] = \
        pallas_phase(torch, models_mod, cfg, ds, det,
                     batches[min(args.batches)], tp, ws)
    log_conv_rows(report["pallas_kernel_calls"])
    log(f"pallas-mode forward vs posgather forward (batch "
        f"{min(args.batches)}): {report['pallas_mode_rel_err']}")

    # ---- 8. result lines
    first_batch = report["main_path"][0]["launches_per_forward"]
    pick = {
        # K1 at L0 (first call); K2 at the L0 16->16 subm conv with the
        # fused epilogue (the first call is the 4->16 input conv)
        "positions": next(r for r in rows if r["name"] == "positions"),
        "posgather_conv": [r for r in rows
                           if r["name"] == "posgather_conv"][1],
    }
    # K3 at the L1->L2 strided conv 32->64 (second forward call), K4 at an
    # L1 32->32 submanifold conv (the largest target list)
    pick["windowed_conv"] = [r for r in train_rows
                             if r["name"] == "windowed_conv"][1]
    pick["windowed_dw"] = next(
        r for r in train_rows if r["name"] == "windowed_dw"
        and r["cin"] == 32 and r["cout"] == 32)
    train_launches = report["train"]["steps"][0]["launches"]
    totals = {}
    for r in train_rows:
        key = (r["name"], r.get("direction", ""))
        tot = totals.setdefault(key, {"ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0, "calls": 0})
        for k in ("ms", "plain_ms", "bound_ms"):
            tot[k] += r[k]
        tot["calls"] += 1
    report["train_kernel_totals"] = {" ".join(k).strip(): v
                                     for k, v in totals.items()}
    log("training kernels, summed over one step's calls: "
        + json.dumps(report["train_kernel_totals"]))
    kernels = []
    for name, r in pick.items():
        # launches: the inference forward's for K1 and K2 (as before), one
        # training step's for K3 and K4; launches_train_step for all four.
        # library_ms: no single PyTorch call computes a window rank, a
        # rank-gather or union-window sparse conv, or its weight gradient
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": first_batch.get(name, train_launches[name]),
            "launches_train_step": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": r.get("device_ms"), "call": r["call"],
            "vt": r["vt"]})
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
