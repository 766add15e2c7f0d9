"""The port's `bev_pool` span (the LSS splat's scatter-add), device ms a
scan of the traced batches (benchmark/program_spans.py)."""

from benchmark.program_spans import per_scan


def read(rec):
    return per_scan("bev_pool")
