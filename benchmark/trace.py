"""The traced run's readings: layer spans from CUDA events, and the device's
busy time and breakdown from torch.profiler.

Spans are recorded from the benchmark's side only, by forward pre- and
post-hooks on the detector and its stage modules and by events around the
decode:
  voxelize    the detector's forward entry -> the sparse backbone's entry
              (`Detector3D._voxelize`, MeanVFE folded in);
  backbone3d  the sparse backbone (`backbone_3d`);
  camera      the image backbone's entry -> the view transform's exit
              (Swin, FPN, DepthLSS with bev_pool);
  bev_head    HeightCompression (`map_to_bev`), and the fuser's (or the BEV
              backbone's) entry -> the dense head's exit;
  decode      `post_process`.
Each span is summed over every batch of the window.
"""

from __future__ import annotations

import collections
import time

import torch

SPANS = {"voxelize": [("det", "pre"), ("backbone_3d", "pre")],
         "backbone3d": [("backbone_3d", "pre"), ("backbone_3d", "post")],
         "camera": [("image_backbone", "pre"), ("vtransform", "post")],
         "bev_head": [("map_to_bev", "pre"), ("map_to_bev", "post"),
                      ("after_bev", "pre"), ("dense_head", "post")],
         "decode": [("decode", "pre"), ("decode", "post")]}


class HostEvent:
    """A host-clock stand-in for torch.cuda.Event where there is no CUDA
    device (the CPU tests)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


class Spans:
    """Events at the stage boundaries of every batch: CUDA events on a CUDA
    device, the host clock elsewhere."""

    def __init__(self, det):
        self.batches, self.cur, self.handles = [], None, []
        self.event = (lambda: torch.cuda.Event(enable_timing=True)) \
            if next(det.parameters()).is_cuda else HostEvent
        mods = {"det": det, "backbone_3d": det.backbone_3d,
                "map_to_bev": det.map_to_bev,
                "image_backbone": det.image_backbone,
                "vtransform": det.vtransform, "dense_head": det.dense_head,
                "after_bev": det.fuser if det.fuser is not None
                else det.backbone_2d}
        for name, mod in mods.items():
            if mod is None:
                continue
            self.handles.append(mod.register_forward_pre_hook(
                lambda *_a, n=name: self.mark(n, "pre")))
            self.handles.append(mod.register_forward_hook(
                lambda *_a, n=name: self.mark(n, "post")))

    def mark(self, name, when):
        if self.cur is None:
            return
        ev = self.event()
        ev.record()
        self.cur[(name, when)] = ev

    def begin(self):
        self.cur = {}

    def end(self):
        self.batches.append(self.cur)
        self.cur = None

    def totals_ms(self):
        """{span: ms summed over the batches} (call after a synchronize)."""
        out = collections.defaultdict(float)
        for evs in self.batches:
            for span, marks in SPANS.items():
                if not all(m in evs for m in marks):
                    continue
                for a, b in zip(marks[::2], marks[1::2]):
                    out[span] += evs[a].elapsed_time(evs[b])
        return dict(out)

    def close(self):
        for h in self.handles:
            h.remove()


def device_intervals(prof):
    """[(start_us, end_us, name)] of every device activity in a profile."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def merged(intervals):
    spans = []
    for s, e, _ in sorted(intervals):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return spans


def host_op_at(cpu_ops, t):
    """The innermost host operation running at time t (us)."""
    best = None
    for s, e, name in cpu_ops:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host (no operation recorded)"


def reduce_profile(prof, window_s):
    """(busy_s, breakdown) of a profiled stretch of `window_s` seconds:
    the union of the device's activity intervals, its 10 longest
    operations by summed time and its 10 longest idle gaps, each named by
    what the host was doing then."""
    dev = device_intervals(prof)
    busy = merged(dev)
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = collections.defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    cpu_ops = [(e.time_range.start, e.time_range.end, e.name)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU]
    gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
            for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    gaps.sort(key=lambda g: -g[0])
    idle = [[host_op_at(cpu_ops, mid), dur / 1e6] for dur, mid in gaps[:10]]
    return busy_s, {"device_ops": [[n, s] for n, s in ops],
                    "idle_gaps": idle}
