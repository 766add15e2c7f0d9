#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--batches 1 8] [--train-batch 4]
                          [--train-steps 3] [--out details.json]
                          [--profile table.txt] [--before DIR]

Phases (any failure exits non-zero and prints no result line):
  1. device — the card's name and power limit, torch/CUDA versions, and the
     nvcc build of the kernels from findnpropagate_torch/ops/csrc/ (three
     sources, one nvcc each, in parallel) into build/kernels/ (with ptxas'
     register / shared-memory report; a register spill in any kernel fails
     the run);
  2. kernels — synthetic corner cases of K2, K3 and K4 at full channel
     widths (a dense cube where all 27 neighbours hit, a window too small,
     blocks of sentinels at the end, a dead block in the middle, Cout 10
     and 3, Cin 4, batch 1 and 4; for K3 also a transposed 128->64 strided
     conv with its window staged and not, and epilogue rows of real
     targets without neighbours) against their plain versions, K1 on each
     of them and on its own corners (tap windows with tap overflow,
     windows too large to stage, no sentinel); then a batch-1 forward of
     the main path records the arguments of every call of K1
     (compute_positions, one launch per level) and K2 (posgather conv);
     each recorded call is re-run through the kernel and through its plain
     PyTorch version on the card: K1 bit-equal in all five fields (lo,
     base, pos, has_real, overflow; also with the prelude given,
     `positions`), K2 within its tolerance. Times are CUDA events after a
     warm-up, around a loop of eager wrapper calls (`ms`) and, for K1, K2
     and K3, around replays of a CUDA graph of the same calls
     (`device_ms`: at batch 1 the eager loop is bound by the host's launch
     work; a K1 call that synced could not be captured); K1 also with
     its window searched in device memory instead of staged in shared
     memory (bit-equal, device ms); the first K1 call also counts, under
     torch.profiler, the stream syncs and host-to-device copies of 5
     calls, which must be 0, and splits its host time under cProfile;
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
     by sample): K1 at batch 4 bit-equal as in phase 2, the others within
     the stated
     tolerance; times as in phase 2; K3's device time with the window
     slice staged in shared memory and searched in device memory at a
     strided call;
  7. pallas-mode forward — a batch-1 eval forward with SUBM_IMPL: pallas
     (every sparse conv through K3 with the fused scale/shift/ReLU/sentinel
     epilogue): each of its 16 K3 launches against the plain version with
     the same epilogue, the forward against the posgather forward on the
     same weights, within bf16 error, and its ms/scan;
  8. probes — the six ported probes of tools/ (findnpropagate_torch/tools/
     probe_gather, probe_gather2, probe_gather3, probe_posgather,
     probe_posgather2 --mode cpu and --mode gpu, probe_posgather3) at their
     own shapes on the card, each exiting 0 (every variant right), with
     the launches of their three kernels (P1 take_along, P2 onehot_gather,
     P3 banded_gather_conv; ops/csrc/gather_probes.cu) counted; then every
     P1-P3 call of that run (but the repeats of the probes' timing loops)
     through the kernel and through its plain version on the card: P1 and
     P2 without weights bit-equal (NaN included), P2 with weights and P3
     within 1e-3 of the output's scale plus one bf16 step of each element;
     for the first call of each signature ms, device ms, plain ms, bound,
     the library call's time (torch.take_along_dim for P1) and, for P1,
     the wrapper's host time split under cProfile. K1's rows
     of phases 2 and 6 carry the library call that computes its ranks,
     torch.searchsorted of all G*Vt queries in one call (its ranks checked
     against K1's where the id is found);
  9. seeker — the Greedy Box Seeker (findnpropagate_torch/openvocab/), no
     kernel of its own: FrustumProposerOG from
     tools/cfgs/nuscenes_models/nuscenes_box_seeker_proposals.yaml at
     bench.py:277-328's shape (numpy seed 0: the 6-camera yaw ring, 200k
     points, 96 detections written as per-camera COCO files under
     build/seeker_dets/ and read back through PreprocessedDetector.infer):
     ms/frame and frames/s (median of 10 propose calls by CUDA events after
     2 warm-ups), host syncs per frame (at most 2), copies and launches per
     frame under the profiler, peak memory, and with --profile the busy
     share and top kernels of one frame (table in <file>.seeker.txt); the
     card's output against the port's own CPU run: valid and labels equal,
     per valid detection boxes within 1e-4 and oracle within 1e-3, unless
     the CPU's two best oracle scores lie within 1e-3 (printed with the
     margin). Then the SEG seeker on the same frame (PointNet weights from
     torch's initialisation at seed 0, the output bias at the median logit
     of the frame's filtered points), its foreground masks and its output
     against the CPU's (a mask may differ only where a point's probability
     lies within 1e-4 of a threshold), and one frame of the KITTI seeker
     (its yaml, a synthetic calibration, 120k points, 32 detections through
     infer_kitti) against the CPU's;
 10. a `kernels` JSON line, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With --before DIR (a checkout of an earlier commit of this repo, e.g.
`git archive` of the parent unpacked under build/), that checkout's K1
(compute_positions, and its K1 kernel alone), K2, K3 and P1 wrappers are
built and timed in the same process on every recorded K1, K3 and P1 call
and phase 2's K2 calls (`before_*`), its K3 in place of this one's for the
pallas-mode forward and for training steps, and its compute_positions in
place of this one's for a batch-1 forward and a training step (each in
turns: before, after, after, before).

Imports nothing of jax. Without CUDA, or without the port beside it, it
exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import inspect
import io
import json
import math
import subprocess
import sys
import time
import traceback
import types
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
    "take_along": "findnpropagate_torch/ops/csrc/gather_probes.cu",
    "onehot_gather": "findnpropagate_torch/ops/csrc/gather_probes.cu",
    "banded_gather_conv": "findnpropagate_torch/ops/csrc/gather_probes.cu",
}
REPLACES = {
    "positions": "findnpropagate_tpu/ops/pallas_posgather.py:75",
    "posgather_conv": "findnpropagate_tpu/ops/pallas_posgather.py:194",
    "windowed_conv": "findnpropagate_tpu/ops/pallas_sparse.py:39",
    "windowed_dw": "findnpropagate_tpu/ops/pallas_sparse.py:285",
    # also probe_gather.py:127, probe_gather2.py:29, probe_gather3.py:29
    "take_along": "tools/probe_gather.py:52",
    # also probe_posgather.py:203
    "onehot_gather": "tools/probe_gather.py:175",
    "banded_gather_conv": "tools/probe_posgather.py:139",
}


# findnpropagate_torch.utils.timing (CUDA-event `ms`, CUDA-graph
# `device_ms`), imported by main() once it has found the port
timing = None


def log(*a):
    print(*a, flush=True)


class Recorder:
    """Wraps a kernel wrapper of the port's ops and keeps a copy of the
    arguments of every call, but of none made while `skip()` is true."""

    def __init__(self, module, name, torch, skip=lambda: False, calls=None):
        self.module, self.name, self.torch = module, name, torch
        self.orig = getattr(module, name)
        self.calls = [] if calls is None else calls
        self.skip = skip

    def __enter__(self):
        def rec(*args, **kw):
            if self.skip():
                return self.orig(*args, **kw)
            clone = lambda x: x.clone() if isinstance(  # noqa: E731
                x, self.torch.Tensor) else x
            self.calls.append(([clone(a) for a in args],
                               {k: clone(v) for k, v in kw.items()}))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


@contextlib.contextmanager
def record_positions(torch, tp):
    """Records every compute_positions call, made through the posgather
    module or through the backbone's own import of it, in call order."""
    import importlib

    bb = importlib.import_module(
        "findnpropagate_torch.models.backbones_3d.spconv_backbone")
    calls = []
    with Recorder(tp, "compute_positions", torch, calls=calls), \
            Recorder(bb, "compute_positions", torch, calls=calls):
        yield calls


def window_union(lo, live, window):
    """The number of source ids that the windows [lo, lo + window) of the
    live blocks cover together, summed over the samples: neighbouring
    blocks' windows overlap, and an id read once serves them all."""
    n = 0
    for starts, keep in zip(lo.cpu().numpy(), live.cpu().numpy() != 0):
        s = np.sort(starts[keep].astype(np.int64))
        if s.size:
            n += int(np.minimum(np.diff(s), window).sum()) + window
    return n


def positions_bound(lp, tgt, span):
    """K1 as one launch per level: the targets read once, the source ids
    under the live blocks' windows once (`window_union`), pos, the three
    per-block arrays and the overflow counts written once; a search of
    log2(span) steps per (target of a live block, group)."""
    b, vt = tgt.shape
    g_n, nb = lp.gdeltas.shape[0], lp.lo.shape[1]
    live = int(lp.has_real.sum())
    nbytes = 4 * (tgt.numel() + window_union(lp.lo, lp.has_real, lp.window)
                  + b * g_n * vt + 3 * b * nb) + 8 * b
    ops = live * lp.block * g_n * math.ceil(math.log2(span + 1))
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


def plain_kw(kw):
    """A recorded K3 call's keywords without the kernel's own (the
    host-side group centres), as the plain version takes them."""
    return {k: v for k, v in kw.items() if k != "centres"}


def with_plan(ws, plan, fn):
    """fn() with K3's plan forced to `plan` (stages, resident, staging)."""
    with Swap(ws, "conv_plan", lambda *a: plan):
        return fn()


def k3_err(torch, out, ref, label):
    """(max abs error, tolerance) of a K3 output against plain; raises
    beyond K3_RTOL of the output's scale or on a non-finite value."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = K3_RTOL * max(float(ref.abs().max()), 1e-3)
    if not (err <= tol and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label}: K3 err {err} > {tol}")
    return err, tol


def check_k3(torch, ws, label, call):
    """`call` (one windowed_conv) with its K3 launch recorded and held
    against the plain version: out, ref, overflow, the recorded args and
    kw, err, tol."""
    with Recorder(ws, "conv_kernel", torch) as rec:
        out, ovf = call()
    (args, kw), = rec.calls
    ref = ws.windowed_conv_plain(*args, **plain_kw(kw))
    err, tol = k3_err(torch, out, ref, label)
    return types.SimpleNamespace(out=out, ref=ref, ovf=int(ovf.sum()),
                                 args=args, kw=kw, err=err, tol=tol)


def corner_scene(torch, so, rng, shape, n_active, cap, batch, cin):
    """`batch` samples of n_active random cells of a small grid (all of
    them: a dense cube), sorted by id and padded to `cap` rows with
    sentinels; features are zero on the padding. Returns (ids, feats,
    coords, valid), coords and valid in the cells' drawn order."""
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
    return ids.contiguous(), feats, coords, valid


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
    """K2, K3 and K4 against their plain versions on synthetic cases (numpy
    seed 0) that the recorded launches of the paths do not reach."""
    rng = np.random.RandomState(0)
    rows = []
    for name, shape, n, cap, b, cin, cout, window, epi in CORNERS:
        ids, feats, _, _ = corner_scene(torch, so, rng, shape, n, cap, b,
                                        cin)
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
        lp = check_level(torch, tp, (ids, ids, deltas),
                         dict(block=block, window=window,
                              sentinel_start=sent), f"corner {name}")[0]
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

        k3 = check_k3(torch, ws, f"corner {name}", lambda: ws.windowed_conv(
            ids, feats, ids, w, deltas, block=block, window=window,
            sentinel_start=sent, **kw))
        if k3.ovf != ovf:
            raise AssertionError(f"corner {name}: K3 overflow {k3.ovf}")
        if epi and not bool((k3.out[ids >= sent] == 0).all()):
            raise AssertionError(f"corner {name}: K3 sentinel rows not 0")
        rows.append({"case": name, "batch": b, "cin": cin, "cout": cout,
                     "overflow": ovf, "dead_blocks": dead,
                     "max_hits": int(hits.max()), "k2_err": err2,
                     "k2_tol": tol2, "k3_err": k3.err, "k3_tol": k3.tol,
                     "k4_err": err4, "k4_tol": tol4})
        log(f"corner {name:28s} batch {b} {cin}->{cout} overflow {ovf} "
            f"dead blocks {dead} max hits {int(hits.max())}: K2 err "
            f"{err2:.3g} (tol {tol2:.3g}), K3 err {k3.err:.3g} (tol "
            f"{k3.tol:.3g}), K4 err {err4:.3g} (tol {tol4:.3g})")
    return rows + k3_corners(torch, ws, so, rng, block) \
        + k1_corners(torch, tp, so, block)


K1_CORNERS = [
    # name, grid, actives, rows, batch, window, tap window, sentinel
    ("tap window, tap overflow", (9, 40, 40), 3000, 4096, 2, 4096, 256,
     True),
    ("window beyond the staged budget", (9, 64, 64), 24000, 24576, 1,
     16384, None, True),
    ("tap window beyond the staged budget", (9, 64, 64), 24000, 24576, 1,
     16384, 1024, True),
    ("no sentinel", (9, 40, 40), 1500, 4096, 2, 1024, None, False),
]


def k1_corners(torch, tp, so, block):
    """K1 against compute_positions_plain (`check_level`) where the
    recorded launches and the conv corners do not reach: tap windows (with
    tap-window overflow), windows too large to stage in shared memory, and
    no sentinel (every block live, its last target the block's last id).
    The conv corners above also hold K1 where the union window overflows
    and on blocks of sentinels alone. Scenes from numpy seed 1."""
    rng = np.random.RandomState(1)
    rows = []
    for name, shape, n, cap, b, window, tap, has_sent in K1_CORNERS:
        ids = corner_scene(torch, so, rng, shape, n, cap, b, 16)[0]
        deltas = so.yxz_offset_deltas((3, 3, 3), shape)
        kw = dict(block=block, window=window, tap_window=tap,
                  sentinel_start=so.yxz_sentinel_start(shape)
                  if has_sent else None)
        lp = check_level(torch, tp, (ids, ids, deltas), kw,
                         f"K1 corner {name}")[0]
        ovf, dead = int(lp.overflow.sum()), int((lp.has_real == 0).sum())
        if name.startswith("tap window") and not ovf > 0:
            raise AssertionError(f"K1 corner {name}: no tap overflow")
        rows.append({"case": name, "batch": b, "window": lp.window,
                     "tap_window": tap, "overflow": ovf,
                     "dead_blocks": dead, "k1_equal": True})
        log(f"K1 corner {name:36s} batch {b} window {lp.window} tap {tap} "
            f"overflow {ovf} dead blocks {dead}: equal to plain")
    return rows


def k3_corners(torch, ws, so, rng, block):
    """K3 alone: (1) the transposed direction of a stride-2 conv at 128 ->
    64 channels (the 64->128 conv's d_feats, source list the coarse base
    ids, the L2->L3 strided window: one stage, the window staged in shared
    memory or searched in device memory); (2) epilogue rows of real
    targets without any neighbour, which must read relu(shift)."""
    from findnpropagate_torch.ops.posgather import flip_transpose_weights

    rows = []
    shape, b = (9, 64, 64), 4
    ids, _, coords, valid = corner_scene(torch, so, rng, shape, 6000, 8192,
                                         b, 16)
    out_shape = tuple((n + 2 - 3) // 2 + 1 for n in shape)
    _, oc, ov = so.win_downsample(coords, valid, shape, out_shape, 8192)
    base = so.strided_base_ids(oc, ov, (2, 2, 2), shape, out_shape)
    deltas = so.strided_deltas((3, 3, 3), (2, 2, 2), (1, 1, 1), shape)
    g = torch.from_numpy(rng.standard_normal(
        (b, base.shape[1], 128)).astype("float32")).cuda()
    w = torch.from_numpy(rng.standard_normal(
        (27, 64, 128)).astype("float32") * 0.05).cuda()
    wt = flip_transpose_weights(w)
    tdeltas = np.ascontiguousarray(-deltas[::-1])
    k3 = check_k3(torch, ws, "transposed 128->64", lambda: ws.windowed_conv(
        base, g, ids, wt, tdeltas, block=block, window=6144))
    if k3.ovf:
        raise AssertionError(f"transposed 128->64: overflow {k3.ovf}")
    src, _, tgt, lo, dl, _, _, window = k3.args
    hits = windowed_hits(torch, ws, src, tgt, lo, dl, block, window)
    plan = ws.conv_plan(128, 64, window)
    other = plan[:2] + (not plan[2],)
    err, tol = k3_err(torch, with_plan(ws, other, lambda: ws.conv_kernel(
        *k3.args, **k3.kw)), k3.ref, f"transposed 128->64 plan {other}")
    for p, e, t in ((plan, k3.err, k3.tol), (other, err, tol)):
        rows.append({"case": "transposed 128->64", "plan": list(p),
                     "batch": b, "window": window, "hits": hits,
                     "k3_err": e, "k3_tol": t})
        log(f"corner transposed 128->64 batch {b} window {window} plan "
            f"{p} hits {hits}: K3 err {e:.3g} (tol {t:.3g})")

    shape = (9, 40, 40)
    sent = so.yxz_sentinel_start(shape)
    ids, feats, _, _ = corner_scene(torch, so, rng, shape, 3000, 4096, 1, 32)
    keep = ids < ids[:, :1500].max()       # sources: the lower half of ids
    src = torch.cat([ids[keep], sent + torch.arange(
        int((~keep).sum()), device="cuda", dtype=ids.dtype)])[None]
    sfeats = torch.cat([feats[keep], feats.new_zeros(
        int((~keep).sum()), 32)])[None]
    w = torch.from_numpy(rng.standard_normal(
        (27, 32, 32)).astype("float32") * 0.1).cuda()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 32).astype(
        "float32")).cuda()
    shift = torch.from_numpy(rng.standard_normal(32).astype(
        "float32")).cuda()
    deltas = so.yxz_offset_deltas((3, 3, 3), shape)
    k3 = check_k3(
        torch, ws, "targets without neighbours", lambda: ws.windowed_conv(
            src, sfeats, ids, w, deltas, block=block, window=4096,
            sentinel_start=sent, scale=scale, shift=shift, relu=True))
    src, _, tgt, lo, dl, _, _, window = k3.args
    lonely = (ws.neighbour_rows(src, tgt, lo, dl, block, window)[1].sum(
        dim=1) == 0) & (ids < sent)
    n = int(lonely.sum())
    if k3.ovf or n < 100 or not torch.equal(
            k3.out[lonely], torch.relu(shift).expand(n, -1)):
        raise AssertionError(f"targets without neighbours: {n} rows, not "
                             "relu(shift), or overflow")
    rows.append({"case": "epilogue, targets without neighbours",
                 "lonely_rows": n, "k3_err": k3.err, "k3_tol": k3.tol})
    log(f"corner epilogue rows without neighbours: {n} rows = relu(shift); "
        f"K3 err {k3.err:.3g} (tol {k3.tol:.3g})")
    return rows


def k1_library(torch, src, tgt, lp):
    """The library call that computes K1's ranks: torch.searchsorted of all
    G*Vt queries (target + group centre) in each sample's sorted source ids,
    in one call. Its global rank is K1's rank (counted from the block's
    window start) plus that start wherever the id is found; checked there.
    Returns the call."""
    b, g_n = tgt.shape[0], lp.gdeltas.shape[0]
    q = (tgt[:, None, :] + lp.gdeltas[None, :, None]).reshape(b, -1)
    hit = lp.pos >= 0
    start = lp.lo.long()[:, None, :, None].expand(
        b, g_n, lp.lo.shape[1], lp.block).reshape(lp.pos.shape)
    rank = torch.searchsorted(src, q).reshape(lp.pos.shape)
    if not torch.equal(rank[hit], lp.pos.long()[hit] + start[hit]):
        raise AssertionError("K1: torch.searchsorted's ranks differ from "
                             "K1's where the id is found")
    return lambda: torch.searchsorted(src, q)


def runtime_calls(torch, fn, reps=5):
    """(stream or device syncs, host-to-device copies, kernel launches) per
    call of fn that torch.profiler records over `reps` calls after a warm
    call, less what it records around as many calls of nothing (the
    profiler's own synchronisation)."""
    from torch.profiler import ProfilerActivity, profile

    def count(f):
        f()
        torch.cuda.synchronize()
        done = torch.cuda.Event()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                f()
            done.record()
            done.synchronize()
        counts = [0, 0, 0]
        for e in prof.key_averages():
            counts[0] += e.count * ("StreamSynchronize" in e.key
                                    or "DeviceSynchronize" in e.key)
            counts[1] += e.count * ("HtoD" in e.key or "cudaMemcpy" in e.key)
            counts[2] += e.count * ("LaunchKernel" in e.key)
        return counts

    base = count(lambda: None)
    return tuple((c - b) / reps for c, b in zip(count(fn), base))


LP_FIELDS = ("lo", "base", "pos", "has_real", "overflow")


def check_level(torch, tp, args, kw, label):
    """K1 (one launch: prelude and search) against compute_positions_plain
    on the card, all five integer fields bit for bit, and the same kernel
    with that prelude given (`positions`; where a tap window is set, with
    tap offsets drawn at random, multiples of 128 in [0, window - span],
    torch seed 0) against positions_plain. Returns both LevelPositions and
    the given-prelude call."""
    lp = tp.compute_positions(*args, **kw)
    ref = tp.compute_positions_plain(*args, **kw)
    torch.cuda.synchronize()
    for f in LP_FIELDS:
        a, r = getattr(lp, f), getattr(ref, f)
        if a.shape != r.shape or not torch.equal(a.long(), r.long()):
            raise AssertionError(f"{label}: K1 {f} != plain")
    src = tp._pad_src(args[0])[0]
    tap = kw.get("tap_window")
    use_tap = tap is not None and tap < ref.window
    b, nb = ref.lo.shape
    shape = (b, nb, ref.gdeltas.shape[0])
    tap_lo = torch.zeros(shape, dtype=torch.int32)
    if use_tap:
        tap_lo = 128 * torch.randint(
            (ref.window - tap) // 128 + 1, shape, dtype=torch.int32,
            generator=torch.Generator().manual_seed(0))
    given = (src, args[1].contiguous(), ref.lo, tap_lo.to(src.device),
             ref.has_real, ref.gdeltas, ref.block,
             tap if use_tap else ref.window, use_tap)
    if not torch.equal(tp.positions(*given), tp.positions_plain(*given)):
        raise AssertionError(f"{label}: K1 with the prelude given != plain")
    return lp, ref, given


def host_us(torch, fn, n=500):
    """Host microseconds per call of fn over n calls (after a warm call),
    on the host's clock, the device synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_split(torch, fn, n=200, least_us=0.5):
    """Where a call's host time goes: host_us of fn, and the microseconds
    per call that cProfile charges to each function it runs (own time; the
    Python function that makes a ctypes call is charged with it, and
    cProfile's own cost is in every entry), those of at least `least_us`."""
    import cProfile
    import pstats

    split = {"call": host_us(torch, fn)}
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    for (path, line, name), st in pstats.Stats(prof).stats.items():
        us = st[2] / n * 1e6
        if us >= least_us and name != "<lambda>":
            where = "" if path == "~" else f"{Path(path).name}:"
            split[where + name] = split.get(where + name, 0.0) + us
    return split


def check_positions(torch, tp, pos_calls, label="", before=None):
    """K1 vs plain, bit for bit, on every recorded compute_positions call
    (`check_level`), beside the library call (`k1_library`); per-call
    rows. The first call also counts the stream syncs and host-to-device
    copies per call (`runtime_calls`); `before`: the earlier checkout's
    compute_positions and K1 timed on the same arguments."""
    rows = []
    for i, (args, kw) in enumerate(pos_calls):
        lp, ref, given = check_level(torch, tp, args, kw,
                                     f"{label}K1 call {i}")
        tap = kw.get("tap_window")
        span = tap if tap is not None and tap < lp.window else lp.window
        library = k1_library(torch, given[0], given[1], ref)
        bound_ms, bound_by = bound_entry(*positions_bound(ref, args[1],
                                                          span))
        call = lambda: tp.compute_positions(*args, **kw)  # noqa: E731
        row = {
            "name": "positions", "call": i, "batch": args[1].shape[0],
            "vt": args[1].shape[1], "vs": given[0].shape[1], "span": span,
            "tap": span != lp.window, "window": lp.window,
            "overflow": int(ref.overflow.sum()),
            "dead_blocks": int((ref.has_real == 0).sum()), "max_abs_err": 0,
            "ms": timing.ms(call, 20),
            "device_ms": timing.device_ms(call, 20),
            "given_prelude_device_ms": timing.device_ms(
                lambda: tp.positions(*given), 20),
            "plain_ms": timing.ms(lambda: tp.compute_positions_plain(
                *args, **kw), 3),
            "library_ms": timing.ms(library, 20),
            "library_device_ms": timing.device_ms(library, 20),
            "bound_ms": bound_ms, "bound_by": bound_by}
        with Swap(tp, "STAGE_WINDOW", False):
            same = all(torch.equal(getattr(tp.compute_positions(*args, **kw),
                                           f).long(), getattr(ref, f).long())
                       for f in LP_FIELDS)
            if not same:
                raise AssertionError(f"{label}K1 call {i}: unstaged != plain")
            row["unstaged_device_ms"] = timing.device_ms(call, 20)
        if i == 0:
            row["host_us"] = host_split(torch, call)
            row["syncs"], row["h2d_copies"], row["launches_seen"] = \
                runtime_calls(torch, call)
            if row["syncs"] or row["h2d_copies"]:
                raise AssertionError(
                    f"{label}K1: compute_positions synced {row['syncs']} "
                    f"times and copied {row['h2d_copies']} times to the "
                    "device per call")
        if before is not None:
            row["before_ms"] = timing.ms(
                lambda: before.compute_positions(*args, **kw), 20)
            row["before_kernel_device_ms"] = timing.device_ms(
                lambda: before.positions(*given), 20)
            if i == 0:
                row["before_syncs"], row["before_h2d_copies"], _ = \
                    runtime_calls(torch, lambda: before.compute_positions(
                        *args, **kw))
                row["before_host_us"] = host_split(
                    torch, lambda: before.compute_positions(*args, **kw))
        rows.append(row)
        del lp, ref, given
    return rows


def log_positions_rows(rows, label=""):
    for r in rows:
        extra = "".join(f" {k} {r[k]:.4f}" for k in (
            "unstaged_device_ms", "before_ms", "before_kernel_device_ms")
            if k in r)
        syncs = (f" syncs {r['syncs']} h2d {r['h2d_copies']} launches "
                 f"{r['launches_seen']}" if "syncs" in r else "") + (
            f" (before: syncs {r['before_syncs']} h2d "
            f"{r['before_h2d_copies']})" if "before_syncs" in r else "")
        log(f"{label}positions call {r['call']:2d} batch {r['batch']} "
            f"vt={r['vt']} span={r['span']} ovf {r['overflow']} dead "
            f"{r['dead_blocks']}: ms {r['ms']:.4f} (device "
            f"{r['device_ms']:.4f}, prelude given "
            f"{r['given_prelude_device_ms']:.4f})  plain "
            f"{r['plain_ms']:.3f}  library {r['library_ms']:.4f} (device "
            f"{r['library_device_ms']:.4f})  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}){extra}{syncs}" + "".join(
                f"  {k} " + " ".join(f"{f} {v:.1f}" for f, v in r[k].items())
                for k in ("host_us", "before_host_us") if k in r))


def check_kernels(torch, tp, pos_calls, conv_calls, before=None):
    """Kernel vs plain on every recorded call; returns per-call rows
    (with `before`, K1 and K2 also timed through the earlier checkout's)."""
    rows = check_positions(torch, tp, pos_calls, before=before)
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
            "ms": timing.ms(lambda: tp.gather_conv(*args, **kw), 10),
            "device_ms": timing.device_ms(
                lambda: tp.gather_conv(*args, **kw), 10),
            "plain_ms": timing.ms(lambda: tp.posgather_conv_plain(
                *args, **kw), 3),
            "bound_ms": bound_ms, "bound_by": bound_by})
        if before is not None:
            rows[-1]["before_device_ms"] = timing.device_ms(
                lambda: before.gather_conv(*args, **kw), 10)
    return rows


def forward_ms(torch, det, batch, reps):
    """(median, all) ms of `reps` forward + post_process, after 2 warm-up
    runs, each timed by CUDA events and synchronised."""
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
    return sorted(times)[len(times) // 2], times


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
    med, times = forward_ms(torch, det, batch, reps)
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
    ds = synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(
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


def check_windowed_conv(torch, ws, k3_calls, direction, label="",
                        before=None):
    """K3 vs plain (sample by sample, with the call's own epilogue
    arguments) on every recorded call; per-call rows. `before`: an earlier
    checkout's K3 wrapper, timed on the same calls."""
    rows = []
    cat = lambda outs: torch.cat(outs, dim=0)          # noqa: E731
    for i, (args, kw) in enumerate(k3_calls):
        src, feats, tgt, lo, deltas, w_flat, block, window = args
        out = ws.conv_kernel(*args, **kw)
        plain = lambda: per_sample(                     # noqa: E731
            ws.windowed_conv_plain, args, plain_kw(kw), (0, 1, 2, 3), cat)
        err, tol = k3_err(torch, out, plain(), f"{label}K3 call {i}")
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
            "ms": timing.ms(lambda: ws.conv_kernel(*args, **kw), 5),
            "device_ms": timing.device_ms(
                lambda: ws.conv_kernel(*args, **kw), 5),
            "plain_ms": timing.ms(plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        if before is not None:
            rows[-1]["before_device_ms"] = timing.device_ms(
                lambda: before.conv_kernel(*args, **kw), 2)
        del out
    return rows


def k3_window_rows(torch, ws, k3_calls):
    """K3's device time with the window slice staged in shared memory (its
    plan) and searched in device memory, at the recorded strided call with
    the widest window whose plan stages it."""
    for args, kw in sorted(k3_calls, key=lambda c: -c[0][7]):
        plan = ws.conv_plan(-(-args[1].shape[2] // 16) * 16,
                            args[5].shape[1], args[7])
        if plan[2] and args[0].shape[1] != args[2].shape[1]:
            break
    rows = []
    for p in (plan, plan[:2] + (False,)):
        ms = with_plan(ws, p, lambda: timing.device_ms(
            lambda: ws.conv_kernel(*args, **kw), 5))
        rows.append({"cin": args[1].shape[2], "cout": args[5].shape[1],
                     "window": args[7], "plan": list(p), "device_ms": ms})
        log(f"K3 window {'staged' if p[2] else 'in device memory'}: "
            f"{args[1].shape[2]}->{args[5].shape[1]} window {args[7]}: "
            f"device {ms:.4f} ms")
    return rows


def check_train_kernels(torch, tp, ws, k2_calls, k3_calls, k4_calls,
                        before=None):
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
            "ms": timing.ms(lambda: tp.gather_conv(*args, **kw), 5),
            "plain_ms": timing.ms(plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    rows += check_windowed_conv(
        torch, ws, k3_calls,
        lambda i: "forward" if i < 3 else "transposed", "train ", before)
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
            "ms": timing.ms(lambda: ws.dw_kernel(*args, **kw), 5),
            "plain_ms": timing.ms(plain, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del out, ref
    return rows


def load_before(path):
    """The K1, K2, K3 and P1 wrappers of an earlier checkout of this repo at
    `path` (`compute_positions`, `positions`, `gather_conv`, `conv_kernel`,
    `take_along`, and its gather-probe module `gp`): its package loaded
    under another name, its kernels built into its own build/, taking this
    checkout's recorded arguments."""
    import importlib
    import importlib.util

    pkg = Path(path).resolve() / "findnpropagate_torch"
    spec = importlib.util.spec_from_file_location(
        "before_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    sys.modules["before_port"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["before_port"])
    bws = importlib.import_module("before_port.ops.windowed_sparse")
    btp = importlib.import_module("before_port.ops.posgather")
    bgp = importlib.import_module("before_port.ops.gather_probes")
    importlib.import_module("before_port.ops._build").build_all(
        ["posgather", "windowed_sparse", "gather_probes"])

    def conv_kernel(*args, centres=None, **kw):
        # the host-side centres, where that checkout's K3 takes them (else
        # it reads the deltas back from the device, which cannot be
        # captured in a CUDA graph)
        if "centres" in inspect.signature(bws.conv_kernel).parameters:
            kw["centres"] = centres
        return bws.conv_kernel(*args, **kw)
    return types.SimpleNamespace(
        conv_kernel=conv_kernel, gather_conv=btp.gather_conv,
        compute_positions=btp.compute_positions, positions=btp.positions,
        take_along=bgp.take_along, gp=bgp)


def k1_before_after(torch, before, run):
    """`run()`'s milliseconds with the earlier checkout's compute_positions
    in the backbone in place of this one's, in turns: before, after, after,
    before."""
    import importlib

    bb = importlib.import_module(
        "findnpropagate_torch.models.backbones_3d.spconv_backbone")
    ab = {"before": [], "after": []}
    for which in ("before", "after", "after", "before"):
        fn = before.compute_positions if which == "before" \
            else bb.compute_positions
        with Swap(bb, "compute_positions", fn):
            ab[which].append(run())
    return ab


class Swap:
    """module.name replaced by `fn` inside the block."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn
        self.orig = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def step_ms(torch, step, batch):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    step(batch)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


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
    ds = synth.SyntheticDataset(
        cfg_mod.EDict(synth.bench_data_cfg(max(b, 2), cfg)),
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
    if args.before is not None:
        # the same steps with the earlier checkout's K3 in place of this
        # one's, in turns: before, after, after, before
        ab = {"before": [], "after": []}
        for which in ("before", "after", "after", "before"):
            fn = (args.before.conv_kernel if which == "before"
                  else ws.conv_kernel)
            with Swap(ws, "conv_kernel", fn):
                ab[which].append(step_ms(torch, step1, batch))
        report["train"]["k3_before_after_ms"] = ab
        log(f"train step with the earlier K3 / this K3: {ab}")
        ab = k1_before_after(torch, args.before,
                             lambda: step_ms(torch, step1, batch))
        report["train"]["k1_before_after_ms"] = ab
        log(f"train step with the earlier / this compute_positions: {ab}")

    # one last step, untimed and after the profiled one, whose kernel
    # arguments are kept for phase 6
    with record_positions(torch, tp) as k1_calls, \
            Recorder(tp, "gather_conv", torch) as k2_rec, \
            Recorder(ws, "conv_kernel", torch) as k3_rec, \
            Recorder(ws, "dw_kernel", torch) as k4_rec:
        run_train_step(torch, step1, batch, tp, ws, lap, 1)

    del det, tx, step1, step2
    torch.cuda.empty_cache()
    pallas_train_phase(torch, mods, cfg, report)
    torch.cuda.empty_cache()
    rows = check_positions(torch, tp, k1_calls, "train ", args.before)
    log_positions_rows(rows, "train ")
    conv_rows = check_train_kernels(torch, tp, ws, k2_rec.calls,
                                    k3_rec.calls, k4_rec.calls,
                                    args.before)
    log_conv_rows(conv_rows)
    report["k3_window"] = k3_window_rows(torch, ws, k3_rec.calls)
    return rows + conv_rows


def pallas_train_phase(torch, mods, cfg, report):
    """One training step at batch 1 in SUBM_IMPL: pallas mode (13
    submanifold and 3 strided convs forward through K3, 12 + 3 transposed,
    16 weight gradients through K4) beside a posgather-mode step on the same
    scene and weights: its own launch counts, overflow 0, and the same loss
    within PALLAS_TRAIN_RTOL."""
    cfg_mod, models_mod, synth, tp, ws, lap, weights, optimization, \
        trainer = mods
    ds = synth.SyntheticDataset(cfg_mod.EDict(synth.bench_data_cfg(2, cfg)),
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


# ------------------------------------------------------------- the probes


PROBE_MAINS = [
    # findnpropagate_torch/tools/<module>, argv: each at its own shapes
    ("probe_gather", []), ("probe_gather2", []), ("probe_gather3", []),
    ("probe_posgather", []), ("probe_posgather2", ["--mode", "cpu"]),
    ("probe_posgather2", ["--mode", "gpu"]), ("probe_posgather3", []),
]
PROBE_KERNELS = ("take_along", "onehot_gather", "banded_gather_conv")


def take_bound(torch, gp, x, idx, axis, taps=False):
    """P1 moves bytes only: the input and the index as given read once,
    the output written once."""
    out = math.prod(gp.index_strides(x, idx, axis, taps)[0]) \
        * x.element_size()
    return (x.numel() * x.element_size() + 4 * idx.numel() + out) \
        / HBM_BYTES_PER_S, 0.0


def onehot_bound(torch, gp, x, ids, want, tap_win=None, wt=None, blocks=1):
    """P2: the inputs once (the first tap_win ids), the output once; a
    search of log2(tap_win) steps per target and block (as the probe's
    blocks repeat it), and with weights 2*Cout*C flops per found id and
    block on the tensor cores."""
    c, s = x.shape
    taps, w = want.shape
    n = s if tap_win is None else tap_win
    rows = taps * c if wt is None else wt.shape[0]
    nbytes = (2 * x.numel() + 4 * n + 4 * want.numel() + 2 * rows * blocks * w
              + (0 if wt is None else 2 * wt.numel()))
    t_ops = blocks * taps * w * math.ceil(math.log2(n + 1)) / CUDA_CORE_OPS
    if wt is not None:
        hits = int(torch.isin(want, ids[:n]).sum())
        t_ops += 2 * wt.shape[0] * c * hits * blocks / BF16_FLOPS
    return nbytes / HBM_BYTES_PER_S, t_ops


def banded_bound(torch, gp, starts, feats, rel, wt, band):
    """P3: the inputs and the bf16 output once; 2*Cout*C flops per gathered
    (target, tap) on the tensor cores."""
    c, s = feats.shape
    nb = starts.shape[0]
    valid = int((gp.band_positions(starts, rel, band, s) >= 0).sum())
    nbytes = (4 * starts.numel() + 2 * feats.numel() + 4 * rel.numel()
              + 2 * wt.numel() + 2 * wt.shape[0] * nb * rel.shape[1])
    return nbytes / HBM_BYTES_PER_S, 2 * wt.shape[0] * c * valid / BF16_FLOPS


def take_library(torch, x, idx, axis, taps=False):
    """One PyTorch call that computes P1 where every index is in range
    (torch.take_along_dim, or indexing for the side-by-side taps), on int64
    indices made beforehand; None elsewhere (it asserts out of range)."""
    if not bool(((idx >= 0) & (idx < x.shape[axis])).all()):
        return None
    i = idx.long()
    if not taps:
        return lambda: torch.take_along_dim(x, i, dim=axis)
    if axis == 1:
        return lambda: torch.take_along_dim(x[None], i[:, None], dim=2)
    it = i.t()
    return lambda: x[it]


def signature(torch, args, kw):
    """A call's shapes, types, strides and other argument values."""
    sig = lambda x: (tuple(x.shape), str(x.dtype), x.stride()) \
        if isinstance(x, torch.Tensor) else repr(x)  # noqa: E731
    return (tuple(sig(a) for a in args),
            tuple((k, sig(v)) for k, v in sorted(kw.items())))


def check_probe_kernels(torch, gp, calls, before=None):
    """Every recorded P1/P2/P3 call of the probes' run through the kernel
    and through its plain version on the card: P1 and P2 without weights
    bit-equal (NaN where the plain version has NaN), P2 with weights and P3
    (bf16 outputs of f32 sums in another order) within 1e-3 of the output's
    scale plus one bf16 step of each element. One row per signature
    (`signature`: calls that differ only in their data), with the number of
    its calls checked, their largest error, and, timed on its first call,
    ms, device ms, plain ms, bound and, for P1, the library call's time and
    the wrapper's host time split (`host_split`; with `before`, also the
    earlier checkout's P1 timed and split on the same call)."""
    from findnpropagate_torch.tools._common import bf16_close, same

    bounds = {"take_along": take_bound, "onehot_gather": onehot_bound,
              "banded_gather_conv": banded_bound}
    rows = []
    for name in PROBE_KERNELS:
        kernel, plain = getattr(gp, name), getattr(gp, name + "_plain")
        by_sig = {}
        for i, (args, kw) in enumerate(calls[name]):
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            exact = name == "take_along" or (
                name == "onehot_gather" and kw.get("wt") is None)
            ok, err = (same(out, ref), 0.0) if exact else bf16_close(out,
                                                                     ref)
            if not ok:
                raise AssertionError(f"{name} call {i}: kernel != plain"
                                     + ("" if exact else f" (err {err})"))
            key = signature(torch, args, kw)
            if key in by_sig:
                row = by_sig[key]
                row["calls"] += 1
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["nan_outputs"] += int(out.isnan().sum())
                continue
            library = take_library(torch, *args, **kw) \
                if name == "take_along" else None
            bound_ms, bound_by = bound_entry(*bounds[name](torch, gp, *args,
                                                           **kw))
            by_sig[key] = {
                "name": name, "call": len(by_sig), "calls": 1,
                "shapes": [list(a.shape) for a in args
                           if isinstance(a, torch.Tensor)],
                "dtype": str(args[0].dtype).replace("torch.", ""),
                "options": {k: (list(v.shape) if isinstance(v, torch.Tensor)
                                else v) for k, v in kw.items()},
                "scalars": [a for a in args
                            if not isinstance(a, torch.Tensor)],
                "nan_outputs": int(out.isnan().sum()),
                "max_abs_err": err, "exact": exact,
                "ms": timing.ms(lambda: kernel(*args, **kw), 20),
                "device_ms": timing.device_ms(
                    lambda: kernel(*args, **kw), 20),
                "plain_ms": timing.ms(lambda: plain(*args, **kw), 3),
                "library_ms": None if library is None
                else timing.ms(library, 20),
                "library_device_ms": None if library is None
                else timing.device_ms(library, 20),
                "bound_ms": bound_ms, "bound_by": bound_by}
            if name == "take_along":
                by_sig[key]["host_us"] = host_split(
                    torch, lambda: kernel(*args, **kw))
                if before is not None:
                    by_sig[key]["before_host_us"] = host_split(
                        torch, lambda: before.take_along(*args, **kw))
                    by_sig[key]["before_ms"] = timing.ms(
                        lambda: before.take_along(*args, **kw), 20)
                    by_sig[key]["before_device_ms"] = timing.device_ms(
                        lambda: before.take_along(*args, **kw), 20)
            rows.append(by_sig[key])
            del out, ref
    return rows


class Tee(io.TextIOBase):
    """A text stream that writes through to `out` and keeps a copy."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def probes_phase(torch, gp, before=None):
    """The six ported probes (findnpropagate_torch/tools/) at their own
    shapes, the P1-P3 launch counts set to 0 just before and read just
    after; then every P1-P3 call of that run held against its plain version
    (`check_probe_kernels`), apart from the repeats inside the probes'
    timing loops and CUDA-graph captures, which relaunch a call already
    recorded on the same tensors. Returns (launches, rows, each probe's
    printed lines)."""
    import importlib

    depth = [0]                      # timing loops under way

    def timed(fn):
        def run(*a, **kw):
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run

    def skip():
        return depth[0] > 0 or torch.cuda.is_current_stream_capturing()

    gp.reset_launches()
    printed = {}
    with contextlib.ExitStack() as stack:
        for fn in ("ms", "device_ms"):
            stack.enter_context(Swap(timing, fn, timed(getattr(timing, fn))))
        recs = {name: stack.enter_context(
            Recorder(gp, name, torch, skip=skip)) for name in PROBE_KERNELS}
        for mod, argv in PROBE_MAINS:
            log(f"-- python -m findnpropagate_torch.tools.{mod} "
                + " ".join(argv))
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                rc = importlib.import_module(
                    f"findnpropagate_torch.tools.{mod}").main(argv)
            printed[" ".join([mod, *argv])] = tee.copy.getvalue(
            ).splitlines()
            if rc != 0:
                raise AssertionError(f"{mod} exited with {rc}")
    torch.cuda.synchronize()
    launches = dict(gp.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"probes: a kernel never launched: {launches}")
    rows = check_probe_kernels(torch, gp, {
        name: rec.calls for name, rec in recs.items()}, before)
    log(f"probe kernel calls held against their plain versions: "
        f"{sum(r['calls'] for r in rows)} ({len(rows)} signatures)")
    for r in rows:
        log(f"{r['name']:18s} call {r['call']:2d} x{r['calls']:<2d} "
            f"{r['dtype']:8s} "
            f"{r['shapes']} {r['scalars']} {r['options']} err "
            f"{r['max_abs_err']:.3g}  ms "
            f"{r['ms']:.4f} (device {r['device_ms']:.4f})  plain "
            f"{r['plain_ms']:.3f}  library "
            + ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} (device "
               f"{r['library_device_ms']:.4f})")
            + f"  bound {r['bound_ms']:.4f} ({r['bound_by']})"
            + ("" if "before_ms" not in r else
               f"  before {r['before_ms']:.4f} (device "
               f"{r['before_device_ms']:.4f})")
            + "".join(f"  {k} " + " ".join(
                f"{f} {v:.1f}" for f, v in r[k].items())
                for k in ("host_us", "before_host_us") if k in r))
    return launches, rows, printed


def log_conv_rows(rows):
    for r in rows:
        dev = (f" (device {r['device_ms']:.4f}"
               + (f", before {r['before_device_ms']:.4f}"
                  if "before_device_ms" in r else "") + ")"
               if "device_ms" in r else "")
        log(f"{r['name']:15s} call {r['call']:2d} "
            f"{r.get('direction', ''):10s} vt={r['vt']} "
            f"{r['cin']}->{r['cout']} hits {r['hits']} err "
            f"{r['max_abs_err']:.3g}  ms {r['ms']:.4f}{dev}  plain "
            f"{r['plain_ms']:.3f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")


def pallas_phase(torch, models_mod, cfg, ds, det, batch, tp, ws, reps,
                 before=None):
    """Phase 7: SUBM_IMPL pallas (K3 + fused epilogue everywhere), batch 1:
    every K3 launch against its plain version with the same epilogue, the
    forward against the posgather forward on the same weights, and its
    ms/scan (with `before`, also with an earlier checkout's K3 in place of
    this one's). Returns (errors, per-call rows, times)."""
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
                               lambda i: "eval epilogue", "pallas mode ",
                               before)
    times = {"ms_per_scan": forward_ms(torch, pdet, batch, reps)[0]}
    if before is not None:
        with Swap(ws, "conv_kernel", before.conv_kernel):
            times["before_ms_per_scan"] = forward_ms(torch, pdet, batch,
                                                     reps)[0]
    log(f"pallas-mode forward, batch 1: {times}")
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
    return errs, rows, times


SEEKER_CFG = "tools/cfgs/nuscenes_models/nuscenes_box_seeker_proposals.yaml"
KITTI_SEEKER_CFG = "tools/cfgs/kitti_models/kitti_box_seeker_proposals.yaml"
# The card's seeker is held against the port's own CPU run on the same
# inputs: valid and labels equal, and per valid detection the same
# proposal (boxes within SEEKER_BOX_ATOL, oracle within SEEKER_ORACLE_ATOL).
# The one allowed exception is a detection whose top two oracle scores on
# the CPU lie within SEEKER_TIE: CUDA's and the CPU's transcendental
# functions differ by an ulp or two, which can move a point across a box
# face or reorder two near-equal proposals. For the SEG filter, a
# detection whose foreground mask differs is allowed only where one of its
# points' CPU probabilities lies within SEG_MARGIN of a decision threshold
# (the network's matmuls sum in another order on the card).
SEEKER_BOX_ATOL = 1e-4
SEEKER_ORACLE_ATOL = 1e-3
SEEKER_TIE = 1e-3
SEG_MARGIN = 1e-4
SEEKER_REPS = 10
# host syncs per nuScenes frame: one to find the rows of the 2D NMS that
# suppress anything, one to size the compacted on-box buffer
SEEKER_SYNCS = 2
# the KITTI frame: a 64-beam sweep's points, 32 detections, and the
# calibration of tests/test_seeker_kitti_parity.py::make_kitti_calib
KITTI_POINTS = 120000
KITTI_DETS = 32
KITTI_P2 = [[721.5, 0.0, 609.6, 44.85], [0.0, 721.5, 172.8, 0.216],
            [0.0, 0.0, 1.0, 0.0027]]
KITTI_V2C = [[0.0, -1.0, 0.0, -0.002], [0.0, 0.0, -1.0, -0.075],
             [1.0, 0.0, 0.0, -0.272]]


def bench_seeker_inputs(num_dets=96, num_points=200000):
    """bench.py:277-328's seeker inputs, numpy seed 0: the 6-camera yaw
    ring (K = 1266.4 / 800 / 450), points uniform in +-54 m with z in
    [-3, 1], 96 random 2D boxes over the cameras."""
    rng = np.random.RandomState(0)
    k = np.array([[1266.4, 0, 800.0], [0, 1266.4, 450.0], [0, 0, 1.0]])
    r_c2l = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    l2i, c2l, intr = [], [], []
    for ci in range(6):
        yaw = ci * np.pi / 3
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        c = np.eye(4)
        c[:3, :3] = rot @ r_c2l
        l2c = np.linalg.inv(c)
        m = np.eye(4)
        m[:3, :3] = k @ l2c[:3, :3]
        m[:3, 3] = k @ l2c[:3, 3]
        i4 = np.eye(4)
        i4[:3, :3] = k
        l2i.append(m)
        c2l.append(c)
        intr.append(i4)
    pts = rng.uniform(-54, 54, (num_points, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 1, num_points)
    boxes = np.zeros((num_dets, 4), np.float32)
    boxes[:, 0] = rng.uniform(0, 1400, num_dets)
    boxes[:, 1] = rng.uniform(0, 700, num_dets)
    boxes[:, 2] = boxes[:, 0] + rng.uniform(40, 200, num_dets)
    boxes[:, 3] = boxes[:, 1] + rng.uniform(40, 200, num_dets)
    labels = rng.randint(1, 11, num_dets).astype(np.int32)
    scores = rng.uniform(0.2, 1.0, num_dets).astype(np.float32)
    cams = rng.randint(0, 6, num_dets).astype(np.int32)
    mats = tuple(np.stack(x).astype(np.float32) for x in (l2i, c2l, intr))
    return mats, pts, (boxes, labels, scores, cams)


def write_coco(path, image_name, class_names, boxes, labels, scores):
    """One COCO-format prediction file (boxes xyxy) for one image."""
    Path(path).write_text(json.dumps({
        "images": [{"id": 1, "file_name": image_name}],
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(class_names)],
        "annotations": [{"image_id": 1, "bbox": [float(v) for v in b],
                         "category_id": int(lb), "score": float(s)}
                        for b, lb, s in zip(boxes, labels, scores)]}))


def top2_margins(torch, calls):
    """Per detection, the gap between its two best valid oracle scores, from
    the recorded nms_normal_bev call of a propose (inf with one valid)."""
    (args, kw), = calls
    s = torch.where(kw["valid_mask"], args[1],
                    torch.full_like(args[1], float("-inf")))
    top = s.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).nan_to_num(float("inf")).cpu().numpy()


def hold_seeker(torch, label, card, cpu, margins, exempt=None):
    """The card's SeekerOutput against the CPU's (see SEEKER_TIE); returns
    the comparison's numbers and its exceptions, each with its margin."""
    exempt = exempt or {}
    card = [t.cpu().numpy() for t in card]
    cpu = [t.numpy() for t in cpu]
    boxes_c, _, oracle_c, labels_c, valid_c = card
    boxes_h, _, oracle_h, labels_h, valid_h = cpu
    if not np.array_equal(labels_c, labels_h):
        raise AssertionError(f"{label}: labels differ between card and CPU")
    if not valid_h.any():
        raise AssertionError(f"{label}: no valid proposal on the CPU")
    exceptions, box_err, oracle_err = [], 0.0, 0.0
    for d in np.nonzero(valid_c | valid_h)[0]:
        if valid_c[d] != valid_h[d]:
            if d not in exempt:
                raise AssertionError(f"{label}: det {d} valid "
                                     f"{valid_c[d]} on the card, "
                                     f"{valid_h[d]} on the CPU")
            exceptions.append({"det": int(d), "why": "seg mask",
                               "margin": exempt[d]})
            continue
        if not np.isfinite(boxes_c[d]).all():
            raise AssertionError(f"{label}: det {d} non-finite box")
        be = float(np.abs(boxes_c[d] - boxes_h[d]).max())
        oe = float(abs(oracle_c[d] - oracle_h[d]))
        if be <= SEEKER_BOX_ATOL and oe <= SEEKER_ORACLE_ATOL:
            box_err, oracle_err = max(box_err, be), max(oracle_err, oe)
            continue
        if d in exempt:
            exceptions.append({"det": int(d), "why": "seg mask",
                               "margin": exempt[d], "box_err": be})
        elif margins[d] < SEEKER_TIE:
            exceptions.append({"det": int(d), "why": "oracle tie",
                               "margin": float(margins[d]), "box_err": be})
        else:
            raise AssertionError(
                f"{label}: det {d} box err {be:.3g}, oracle err {oe:.3g}, "
                f"CPU top-two margin {margins[d]:.3g}")
    for e in exceptions:
        log(f"  {label} exception: det {e['det']} ({e['why']}, margin "
            f"{e['margin']:.3g})")
    return {"dets": len(valid_h), "valid": int(valid_h.sum()),
            "max_box_err": box_err, "max_oracle_err": oracle_err,
            "exceptions": exceptions}


def frame_ms(torch, fn, reps, warm=2):
    """(median, all) ms of `reps` calls of fn after `warm`, each timed by
    CUDA events and synchronised."""
    times = []
    for i in range(reps + warm):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2], times


def profile_frame(torch, fn, path):
    """One call of fn under torch.profiler: wall, summed kernel time, busy
    share and the five kernels with the most device time; the table goes
    to `path`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" or "cuda" in str(
                  e.device_type).lower()]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=40))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / (wall * 1e3),
            "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3)
                            for e in top]}


def seg_head_at_median(torch, seg, args, dev):
    """Random weights give every point of a frustum nearly the same logits
    (the 1024-wide global feature dominates), so the filter would keep all
    points or none. Zero logit 0 and move logit 1's bias to the median over
    the points of the frame's filtered detections (more than seg_pts_thr
    points; all detections are real here): half of them become
    foreground."""
    seen = []
    hook = seg.seg_net.register_forward_hook(
        lambda mod, inp, out: seen.append((out, inp[2])))
    seg.seg_point_masks(*args, device=dev)
    hook.remove()
    logits, valid = seen[0]
    used = valid & (valid.sum(-1, keepdim=True) > seg.seg_pts_thr)
    state = {k: v.clone() for k, v in seg.seg_net.state_dict().items()}
    state["seg_out.weight"][0] = 0.0
    state["seg_out.bias"][0] = 0.0
    state["seg_out.bias"][1] -= logits[..., 1][used].median()
    return {k: v.cpu() for k, v in state.items()}


def seg_margins(torch, seg, args):
    """The SEG masks on the CPU and, per detection, the least distance of
    a filtered point's foreground probability from a decision threshold."""
    seen = []
    hook = seg.seg_net.register_forward_hook(
        lambda mod, inp, out: seen.append((out, inp[2])))
    masks = seg.seg_point_masks(*args, device="cpu")
    hook.remove()
    logits, valid = seen[0]
    prob = torch.sigmoid(logits)
    gap = torch.minimum((prob[..., 1] - prob[..., 0]).abs(),
                        (prob[..., 1] - seg.seg_thr).abs())
    gap = torch.where(valid, gap, torch.full_like(gap, float("inf")))
    return masks, gap.amin(-1).numpy()


def seeker_phase(torch, profile=None, device="cuda"):
    """The Greedy Box Seeker on the card: FrustumProposerOG from the
    nuScenes seeker yaml at bench.py's shape (200k points, 96 detections
    loaded from per-camera COCO files through PreprocessedDetector),
    frames/s, host syncs per frame, peak memory (and under --profile the
    busy share and top kernels), held against the port's CPU run; then
    one frame each of the KITTI seeker (its yaml, a synthetic calibration,
    120k points, 32 detections through infer_kitti) and of the SEG seeker
    (random PointNet weights, seed 0) against their CPU runs. `device`
    names the card (another device only to rehearse the phase)."""
    from findnpropagate_torch import config as cfg_mod
    from findnpropagate_torch.models.frustum_pointnets import (
        PointNetInstanceSeg,
    )
    from findnpropagate_torch.openvocab import frustum_proposer as fp
    from findnpropagate_torch.openvocab import frustum_proposer_kitti as fk
    from findnpropagate_torch.openvocab.frustum_proposer_seg import (
        FrustumProposerSEG,
    )
    from findnpropagate_torch.openvocab.preprocessed_detector import (
        CAMERA_NAMES,
        PreprocessedDetector,
    )

    out = {}
    dev = torch.device(device)
    work = ROOT / "build" / "seeker_dets"
    work.mkdir(parents=True, exist_ok=True)

    # ---- nuScenes, bench shape
    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / SEEKER_CFG))
    head = cfg.MODEL.DENSE_HEAD
    seeker = fp.FrustumProposerOG.from_config(head, cfg.CLASS_NAMES)
    (l2i, c2l, intr), pts, (boxes, labels, scores, cams) = \
        bench_seeker_inputs()
    preds, images = [], []
    for c, name in enumerate(CAMERA_NAMES):
        images.append(f"samples/{name}/frame0__{name}.jpg")
        preds.append(work / f"{name}.json")
        sel = cams == c
        write_coco(preds[-1], images[-1], cfg.CLASS_NAMES, boxes[sel],
                   labels[sel], scores[sel])
    detector = PreprocessedDetector(preds, cfg.CLASS_NAMES, box_fmt="xyxy",
                                    max_dets=len(boxes))
    dets = detector.infer(images)
    if int(dets["det_mask"].sum()) != len(boxes):
        raise AssertionError("seeker: PreprocessedDetector lost detections")
    det_args = [dets[k] for k in ("det_boxes", "det_labels", "det_scores",
                                  "det_cams", "det_mask")]
    pts_d = torch.from_numpy(pts).to(dev)
    mask_d = torch.ones(len(pts), dtype=torch.bool, device=dev)
    mats_d = [torch.from_numpy(m).to(dev) for m in (l2i, c2l, intr)]

    def frame():
        return seeker.propose(pts_d, mask_d, *det_args, *mats_d,
                              device=dev)

    card = frame()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    med, times = frame_ms(torch, frame, SEEKER_REPS)
    # the frames' own peak, above what was allocated before them
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    syncs, copies, launches = runtime_calls(torch, frame, reps=3)
    out["nuscenes"] = {
        "points": len(pts), "dets": len(boxes), "ms_per_frame": med,
        "frames_per_s": 1e3 / med, "times_ms": times,
        "host_syncs_per_frame": syncs, "copies_per_frame": copies,
        "kernel_launches_per_frame": launches, "peak_mem_gb": peak}
    if profile:
        out["nuscenes"]["profile"] = profile_frame(
            torch, frame, str(profile) + ".seeker.txt")
    with Recorder(fp, "nms_normal_bev", torch) as rec:
        cpu = seeker.propose(pts, np.ones(len(pts), bool), *det_args,
                             l2i, c2l, intr, device="cpu")
    out["nuscenes"]["vs_cpu"] = hold_seeker(
        torch, "seeker nuScenes", card, cpu, top2_margins(torch, rec.calls))
    r = out["nuscenes"]
    log(f"seeker nuScenes ({len(pts)} points, {len(boxes)} dets): "
        f"{r['ms_per_frame']:.2f} ms/frame, {r['frames_per_s']:.2f} "
        f"frames/s (median of {SEEKER_REPS}), per frame {syncs:g} host "
        f"syncs, {copies:g} copy records (memcpy calls and transfers, any "
        f"direction), {launches:g} kernel launches; peak {peak:.3f} GiB; "
        f"card vs CPU "
        f"{r['vs_cpu']['valid']} valid of {r['vs_cpu']['dets']}, max box "
        f"err {r['vs_cpu']['max_box_err']:.3g}, oracle err "
        f"{r['vs_cpu']['max_oracle_err']:.3g}, "
        f"{len(r['vs_cpu']['exceptions'])} exceptions")
    if profile:
        p = r["profile"]
        log(f"seeker profile: wall {p['wall_ms']:.2f} ms, kernels "
            f"{p['kernel_ms']:.2f} ms, busy {p['busy_share']:.3f}; top "
            + "; ".join(f"{n} {t:.3f}" for n, t in p["top_kernels"]))
    if syncs > SEEKER_SYNCS:
        raise AssertionError(f"seeker: {syncs} host syncs per frame, want "
                             f"at most {SEEKER_SYNCS}")

    # ---- SEG on the same frame
    # torch's own initialisation from seed 0 (init_random_'s N(0, 0.05^2)
    # leaves every ReLU of the 1024-wide layers dead: constant logits)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = PointNetInstanceSeg(6)
    seg_args = (pts_d, mask_d, det_args[0], det_args[1], det_args[3],
                det_args[4], mats_d[0])
    seg = FrustumProposerSEG.from_config(head, cfg.CLASS_NAMES,
                                         seg_params=net.state_dict())
    seg = FrustumProposerSEG.from_config(
        head, cfg.CLASS_NAMES,
        seg_params=seg_head_at_median(torch, seg, seg_args, dev))
    masks_card = seg.seg_point_masks(*seg_args, device=dev).cpu()
    cpu_args = (pts, np.ones(len(pts), bool), *det_args)
    masks_cpu, gaps = seg_margins(
        torch, seg, (cpu_args[0], cpu_args[1], cpu_args[2], cpu_args[3],
                     cpu_args[5], cpu_args[6], l2i))
    exempt = {}
    for d in np.nonzero((masks_card != masks_cpu).any(-1).numpy())[0]:
        if not gaps[d] < SEG_MARGIN:
            raise AssertionError(f"seeker SEG: det {d} mask differs, least "
                                 f"probability margin {gaps[d]:.3g}")
        exempt[int(d)] = float(gaps[d])
    ms_seg, _ = frame_ms(torch, lambda: seg.propose(
        pts_d, mask_d, *det_args, *mats_d, device=dev), 3, warm=1)
    card = seg.propose(pts_d, mask_d, *det_args, *mats_d, device=dev)
    with Recorder(fp, "nms_normal_bev", torch) as rec:
        cpu = seg.propose(*cpu_args, l2i, c2l, intr, device="cpu")
    filtered = ~masks_cpu.all(-1)
    kept = int(masks_cpu[filtered].sum())
    if not filtered.any() or kept == 0:
        raise AssertionError("seeker SEG: the filter kept nothing or ran "
                             "on no detection")
    out["seg"] = {"ms_per_frame": ms_seg, "filtered_dets": int(
                      filtered.sum()), "kept_points": kept,
                  "mask_dets_differing": len(exempt),
                  "vs_cpu": hold_seeker(torch, "seeker SEG", card, cpu,
                                        top2_margins(torch, rec.calls),
                                        exempt)}
    r = out["seg"]
    log(f"seeker SEG: {ms_seg:.2f} ms/frame (median of 3), "
        f"{r['filtered_dets']} dets filtered ({kept} points kept), masks "
        f"differing card vs CPU in {len(exempt)} dets, "
        f"{r['vs_cpu']['valid']} valid, max box err "
        f"{r['vs_cpu']['max_box_err']:.3g}, "
        f"{len(r['vs_cpu']['exceptions'])} exceptions")

    # ---- KITTI, one frame
    kcfg = cfg_mod.cfg_from_yaml_file(str(ROOT / KITTI_SEEKER_CFG))
    kseeker = fk.FrustumProposerOGKITTI.from_config(kcfg.MODEL.DENSE_HEAD,
                                                    kcfg.CLASS_NAMES)
    rng = np.random.RandomState(1)
    n_k, d_k = KITTI_POINTS, KITTI_DETS
    kpts = np.stack([rng.uniform(0, 70.4, n_k), rng.uniform(-40, 40, n_k),
                     rng.uniform(-3, 1, n_k)], -1).astype(np.float32)
    kb = np.zeros((d_k, 4), np.float32)
    kb[:, 0] = rng.uniform(0, 1100, d_k)
    kb[:, 1] = rng.uniform(80, 280, d_k)
    kb[:, 2] = kb[:, 0] + rng.uniform(30, 140, d_k)
    kb[:, 3] = kb[:, 1] + rng.uniform(30, 90, d_k)
    write_coco(work / "kitti.json", "000042.png", kcfg.CLASS_NAMES, kb,
               rng.randint(1, 8, d_k), rng.uniform(0.2, 1.0, d_k))
    kd = PreprocessedDetector([work / "kitti.json"], kcfg.CLASS_NAMES,
                              box_fmt="xyxy", max_dets=d_k).infer_kitti(
        "000042")
    th = 0.004
    calib = (np.array(KITTI_P2, np.float32),
             np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32),
             np.array(KITTI_V2C, np.float32))
    kargs = [kd[k] for k in ("det_boxes", "det_labels", "det_scores",
                             "det_mask")]
    kpts_d = torch.from_numpy(kpts).to(dev)
    kmask_d = torch.ones(n_k, dtype=torch.bool, device=dev)
    ms_k, _ = frame_ms(torch, lambda: kseeker.propose(
        kpts_d, kmask_d, *kargs, *calib, device=dev), 3, warm=1)
    card = kseeker.propose(kpts_d, kmask_d, *kargs, *calib, device=dev)
    with Recorder(fk, "nms_normal_bev", torch) as rec:
        cpu = kseeker.propose(kpts, np.ones(n_k, bool), *kargs, *calib,
                              device="cpu")
    out["kitti"] = {"points": n_k, "dets": d_k, "ms_per_frame": ms_k,
                    "vs_cpu": hold_seeker(torch, "seeker KITTI", card, cpu,
                                          top2_margins(torch, rec.calls))}
    r = out["kitti"]
    log(f"seeker KITTI ({n_k} points, {d_k} dets): {ms_k:.2f} ms/frame "
        f"(median of 3), {r['vs_cpu']['valid']} valid, max box err "
        f"{r['vs_cpu']['max_box_err']:.3g}, "
        f"{len(r['vs_cpu']['exceptions'])} exceptions")
    return out


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
    ap.add_argument("--before", default=None,
                    help="a checkout of an earlier commit of this repo "
                    "whose K1, K2, K3 and P1 are timed beside this one's")
    args = ap.parse_args()
    global timing

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
        from findnpropagate_torch.ops import gather_probes as gp
        from findnpropagate_torch.ops import posgather as tp
        from findnpropagate_torch.ops import sparse_ops
        from findnpropagate_torch.ops import windowed_sparse as ws
        from findnpropagate_torch.runtime import optimization, trainer
        from findnpropagate_torch.utils import timing, weights
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    if args.before:
        args.before = load_before(args.before)
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
    sources = ["posgather", "windowed_sparse", "gather_probes"]
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
        spilled = {fn: n for fn, n in _build.spills(
            _build.PTXAS_LOG.get(name, "")).items() if n}
        if spilled:
            raise AssertionError(f"register spills in {name}: {spilled}")

    cfg = cfg_mod.cfg_from_yaml_file(str(ROOT / CFG_FILE))
    nmax = max(max(args.batches), 2)
    ds = synth.SyntheticDataset(
        cfg_mod.EDict(synth.bench_data_cfg(nmax, cfg)), cfg.CLASS_NAMES)
    det = models_mod.build_network(copy.deepcopy(cfg.MODEL), 10, ds)
    weights.init_random_(det, seed=0)
    batches = {b: {k: torch.from_numpy(v).cuda()
                   for k, v in ds.batch(range(b)).items()}
               for b in args.batches}

    # ---- 2. kernels vs plain: corner cases, then the main path's own
    # arguments
    report["corner_cases"] = corner_phase(torch, tp, ws, sparse_ops)
    with record_positions(torch, tp) as pos_calls, \
            Recorder(tp, "gather_conv", torch) as conv_rec:
        det.post_process(det(batches[min(args.batches)]))
        torch.cuda.synchronize()
        # K1's tap sub-window mode (not on the main path: the port ranks
        # over the union window) at L0, with the yaml's L0 tap window
        src = pos_calls[0][0][0]
        s1 = det.backbone_3d.level_shapes[0]
        bb = cfg.MODEL.BACKBONE_3D
        tp.compute_positions(
            src, src, sparse_ops.yxz_offset_deltas((3, 3, 3), s1),
            int(bb.WINDOWED_BLOCK), int(bb.WINDOWED_WINDOW[0]),
            tap_window=int(bb.TAP_WINDOW[0]),
            sentinel_start=sparse_ops.yxz_sentinel_start(s1))
    rows = check_kernels(torch, tp, pos_calls, conv_rec.calls, args.before)
    report["kernel_calls"] = rows
    log_positions_rows([r for r in rows if r["name"] == "positions"])
    for r in rows:
        if r["name"] == "positions":
            continue
        dev = (f" (device {r['device_ms']:.4f}" + (
            f", before {r['before_device_ms']:.4f}"
            if "before_device_ms" in r else "") + ")"
            if "device_ms" in r else "")
        log(f"{r['name']:15s} call {r['call']:2d} vt={r['vt']} "
            f"{r['cin']}->{r['cout']} epi={int(r['epilogue'])} "
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

    if args.before is not None:
        b = min(args.batches)
        ab = k1_before_after(torch, args.before, lambda: forward_ms(
            torch, det, batches[b], args.reps)[0])
        report["main_path_k1_before_after_ms"] = {"batch": b, **ab}
        log(f"main path batch {b}, ms/batch with the earlier / this "
            f"compute_positions: {ab}")

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
    report["pallas_mode_rel_err"], report["pallas_kernel_calls"], \
        report["pallas_forward"] = pallas_phase(
            torch, models_mod, cfg, ds, det, batches[min(args.batches)], tp,
            ws, args.reps, args.before)
    log_conv_rows(report["pallas_kernel_calls"])
    log(f"pallas-mode forward vs posgather forward (batch "
        f"{min(args.batches)}): {report['pallas_mode_rel_err']}")

    # ---- 8. the ported probes and their kernels
    report["probe_launches"], report["probe_kernel_calls"], \
        report["probe_output"] = probes_phase(torch, gp, args.before)
    log(f"probe launches: {report['probe_launches']}")

    # ---- 9. the Greedy Box Seeker: nuScenes, SEG, KITTI
    report["seeker"] = seeker_phase(torch, args.profile)

    # ---- 10. result lines
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
        # library_ms: torch.searchsorted for K1 (k1_library); no single
        # PyTorch call computes a rank-gather or union-window sparse conv,
        # or its weight gradient
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": first_batch.get(name, train_launches[name]),
            "launches_train_step": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "library_device_ms": r.get("library_device_ms"),
            "device_ms": r.get("device_ms"), "call": r["call"],
            "vt": r["vt"]})
    # the probes' kernels, at the probes' own shapes: P1 at probe_gather's
    # stacked taps (27 x 1024 over a (16, 2048) bf16 window), P2 at
    # probe_posgather's one-hot reference (weight stage, 118 blocks), P3 at
    # band 3; launches: the probes' run
    probe_rows = report["probe_kernel_calls"]
    probe_pick = {
        "take_along": next(
            r for r in probe_rows if r["name"] == "take_along"
            and r["options"].get("taps") and r["scalars"] == [1]),
        "onehot_gather": next(
            r for r in probe_rows if r["name"] == "onehot_gather"
            and "wt" in r["options"]),
        "banded_gather_conv": next(
            r for r in probe_rows if r["name"] == "banded_gather_conv"
            and r["scalars"] == [3]),
    }
    for name, r in probe_pick.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": report["probe_launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"],
            "device_ms": r["device_ms"], "call": r["call"],
            "shapes": r["shapes"]})
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
