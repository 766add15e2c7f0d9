"""Named spans at the port's layer boundaries, recorded only while a torch
profiler records.

A span is on exactly while `torch.profiler` (or the autograd profiler) is
recording on the calling thread: there is no knob. Off, `span` returns one
shared no-op object and costs one check of the profiler's state. On, it
opens a named range in the profile (so the chrome trace shows it on the
host's timeline, on the device trace's clock), takes the host clock at
entry and exit and, on a CUDA path, a pair of timing CUDA events on the
current stream (the host clock stands in on the CPU and inside a CUDA
graph's capture). Each record keeps its name, its parent (the innermost
open span) and its batch: the count of the `forward` root it ran in.

The range is of the function scope (`_RecordFunctionFast`), not the user
scope of `torch.profiler.record_function`: a user-scope range is copied
onto the device's timeline as an annotation event of the CUDA device type,
which a reader of `prof.events()` that takes every device event for work
would count as busy time.

The spans (callers in brackets):
  forward        the root of a batch, with its scans (DetectorModule.forward);
  voxelize, vfe, backbone_3d, map_to_bev, image_backbone, neck,
  vtransform, fuser, backbone_2d, dense_head, roi_proposal, pfe,
  point_head, roi_head
                 the detector's stages, named by attribute;
  active_set     building a level's sorted active set (the sparse backbone);
  dense_conv     a dense level's F.conv3d with its mask, BN, residual and
                 ReLU (at eval inside it: dense_epilogue, the fused tail);
  positions, posgather_conv, windowed_conv, windowed_dw
                 the K1-K4 wrappers;
  bev_pool       the LSS splat;
  decode         `post_process`: a root in the batch of the forward before;
  loss, assign, backward, optimizer
                 the training step (the head's Hungarian matching in assign).
A root other than `forward` joins the batch of the last forward. The
records stay until `reset()`: a job that profiles again and again resets
after reading them.

    with torch.profiler.profile(...) as prof:
        dets = det.post_process(det(batch))
    torch.cuda.synchronize()
    trace.totals()["spans"]["backbone_3d"]["device_ms"]
"""

from __future__ import annotations

import functools
import time

import torch

_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span of a run that no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _HostEvent:
    """The host clock in the place of a CUDA event."""

    __slots__ = ("ns",)

    def record(self):
        self.ns = time.perf_counter_ns()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


class _State:
    records = []      # every span entered since the last reset, in order
    open = []         # the spans entered and not yet left
    forwards = 0      # forward roots recorded
    last = None       # the last forward root


def _clock(cuda):
    if cuda and not torch.cuda.is_current_stream_capturing():
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


class _Span:
    __slots__ = ("name", "parent", "batch", "scans", "cuda", "range",
                 "t0", "t1", "ev0", "ev1")

    def __init__(self, name, scans):
        self.name = name
        self.scans = scans

    def __enter__(self):
        parent = _State.open[-1] if _State.open else None
        self.parent = parent
        if parent is not None:
            self.batch, self.cuda = parent.batch, parent.cuda
            self.scans = None
        elif self.scans is not None:
            t = self.scans
            self.batch = _State.forwards
            self.cuda = bool(getattr(t, "is_cuda", False))
            self.scans = int(t.shape[0]) if hasattr(t, "shape") else int(t)
            _State.forwards += 1
            _State.last = self
        elif _State.last is not None:
            self.batch, self.cuda = _State.last.batch, _State.last.cuda
        else:
            self.batch, self.cuda = None, False
        self.range = _Range(self.name)
        self.range.__enter__()
        self.ev0, self.ev1 = _clock(self.cuda), _clock(self.cuda)
        self.t1 = None
        self.t0 = time.perf_counter_ns()
        self.ev0.record()
        _State.open.append(self)
        _State.records.append(self)
        return self

    def __exit__(self, *exc):
        self.ev1.record()
        self.t1 = time.perf_counter_ns()
        _State.open.pop()
        self.range.__exit__(*exc)
        return False


def span(name, scans=None):
    """A context manager over one span. `scans`, on a root: the batch's
    size, or a tensor with the batch on its leading axis (whose device
    picks CUDA events or the host clock); such a root starts a batch."""
    if not _enabled():
        return OFF
    return _Span(name, scans)


def spanned(name):
    """A decorator: every call of the function in a span of `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return call
    return wrap


def records():
    """[{name, parent (its name or None), batch, scans}] of every span
    recorded since the last reset, in the order they were entered."""
    return [{"name": r.name,
             "parent": None if r.parent is None else r.parent.name,
             "batch": r.batch, "scans": r.scans}
            for r in _State.records]


def totals():
    """{"spans": {name: {calls, device_ms, host_ms, self_ms}}, "scans",
    "batches"} over the finished spans since the last reset: device_ms
    from the CUDA events (the host clock off CUDA), self_ms a span's
    device_ms less its direct children's, scans and batches those of the
    forward roots. Waits for the recorded events."""
    done = [r for r in _State.records if r.t1 is not None]
    for r in done:
        r.ev1.synchronize()
    dev = {id(r): r.ev0.elapsed_time(r.ev1) for r in done}
    children = {}
    for r in done:
        if r.parent is not None:
            children[id(r.parent)] = children.get(id(r.parent), 0.0) \
                + dev[id(r)]
    spans, scans, batches = {}, 0, 0
    for r in done:
        t = spans.setdefault(r.name, {"calls": 0, "device_ms": 0.0,
                                      "host_ms": 0.0, "self_ms": 0.0})
        t["calls"] += 1
        t["device_ms"] += dev[id(r)]
        t["host_ms"] += (r.t1 - r.t0) / 1e6
        t["self_ms"] += dev[id(r)] - children.get(id(r), 0.0)
        if r.parent is None and r.scans is not None:
            scans += r.scans
            batches += 1
    return {"spans": spans, "scans": scans, "batches": batches}


def reset():
    """Forget every record (the spans open now end unrecorded)."""
    _State.records = []
    _State.forwards = 0
    _State.last = None
