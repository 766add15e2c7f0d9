"""The 'voxelize' span of trace.py, summed over the window's batches, per
scan; None where the cell has no such span."""


def read(rec):
    ms = rec.get("span_ms", {}).get("voxelize")
    return None if ms is None else ms / rec["scans"]
