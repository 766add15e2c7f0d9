"""The port's own spans as per-layer readings.

The program (findnpropagate_torch/utils/trace.py) records its spans while
a torch profiler records, so in the traced run only: the warm-up's
profiled batch and the batches of the profiled stretch. A reading is a
span's milliseconds summed over those batches, over their scans. It is
None where the trace recorded no such span (an untraced run, the control,
a cell without that layer) and where the program has no spans (an older
checkout).
"""

from __future__ import annotations


def per_scan(name, key="device_ms"):
    """Span `name`'s `key` (device_ms, host_ms or self_ms) a recorded
    scan, or None."""
    try:
        from findnpropagate_torch.utils import trace
    except ImportError:
        return None
    tot = trace.totals()
    span = tot["spans"].get(name)
    if span is None or not tot["scans"]:
        return None
    return span[key] / tot["scans"]
