"""Timing on the card: CUDA events around a loop of eager calls (`ms`) and
around replays of a CUDA graph of the same calls (`device_ms`).

A kernel of a few microseconds called from Python is bound by the host's
launch work (the wrapper's checks and small PyTorch operations), so `ms`
measures that; `device_ms` captures `reps` calls once and replays them, so
only the device's time is left. A function that waits for the stream (a
host read of a device value) cannot be captured: time it with `ms`.
Both need a CUDA device and synchronise it.
"""

from __future__ import annotations

import torch


def ms(fn, reps: int, warm: int = 1) -> float:
    """Milliseconds per call of `reps` eager calls of fn, after `warm`."""
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


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call: `reps` calls of fn captured once into
    a CUDA graph (after one eager warm-up call) and replayed."""
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
    return ms(graph.replay, 3) / reps


def in_turns(before, after):
    """{"before": [b1, b2], "after": [a1, a2]}: the two measurements (each
    a call returning a number) taken twice in turns: before, after, after,
    before, so that a drift of the card between them shows."""
    got = {"before": [], "after": []}
    for which in ("before", "after", "after", "before"):
        got[which].append((before if which == "before" else after)())
    return got
