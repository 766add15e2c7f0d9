"""The closed loop of offline inference: one batch in flight, the next due
when the last one's detections are on the host. A traffic mix names it by
`"loop": "closed"`.

A loop gives the harness:
  inputs(config, traffic, seed, device)  the mix's batches (inputs.py);
  warm_up(side, inputs, device, trace)   every shape the window will run;
  window(side, inputs, seconds, picks, device, failed, spans, profile_at)
      the measured window: (record, captures of the batches in `picks`,
      the profiler or None).
"""

from __future__ import annotations

import time

import torch

from benchmark.inputs import Traffic


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def inputs(config, traffic, seed, device):
    return Traffic(config, traffic, seed, device)


@torch.no_grad()
def warm_up(side, inputs, device, trace):
    """Every pool batch once and the first again (the sides that build
    nothing skip it); under --trace, the profiler's first start too (CUPTI
    takes seconds), so that neither falls in the window."""
    if side.warm_up:
        for i in range(len(inputs.batches) + 1):
            dets, _ = side.infer(inputs.to_device(i))
            [t.to("cpu") for t in dets]
    if trace:
        with profiler():
            side.infer(inputs.to_device(0))
            sync(device)
    sync(device)


@torch.no_grad()
def window(side, inputs, seconds, picks, device, failed, spans=None,
           profile_at=None):
    """The closed loop for `seconds`, and on until every batch in `picks`
    has been served. `failed(dets)` counts a batch's failed scans;
    `profile_at` (start, length) in seconds from the window's start."""
    lat, caps, n_failed = [], {}, 0
    prof = prof_t0 = None
    prof_s = 0.0
    profiling = False
    i = 0
    t0 = due = time.perf_counter()
    while True:
        if profile_at is not None and prof is None \
                and due - t0 >= profile_at[0]:
            prof = profiler()
            prof.start()
            prof_t0 = time.perf_counter()
            profiling = True
        batch = inputs.to_device(i)
        if spans is not None:
            spans.begin()
        dets, cap = side.infer(batch, capture=i in picks)
        if spans is not None:
            spans.end()
        host = [t.to("cpu") for t in dets]
        sync(device)
        now = time.perf_counter()
        lat.append(now - due)
        n_failed += failed(host)
        if cap is not None:
            caps[i] = cap
        if profiling and now - prof_t0 >= profile_at[1]:
            prof.stop()
            prof_s = now - prof_t0
            profiling = False
        due = now
        i += 1
        if now - t0 >= seconds and i > max(picks, default=-1):
            break
    if profiling:
        prof.stop()
        prof_s = time.perf_counter() - prof_t0
    rec = {"batches": i, "scans": i * inputs.scenes_per_batch,
           "window_s": due - t0, "latencies_s": lat, "failed": n_failed,
           "profiled_s": prof_s}
    return rec, caps, prof
