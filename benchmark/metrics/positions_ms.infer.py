"""K1: the port's `positions` span (`compute_positions`), device ms a
scan of the traced batches (benchmark/program_spans.py)."""

from benchmark.program_spans import per_scan


def read(rec):
    return per_scan("positions")
