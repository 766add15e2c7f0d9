"""K2: the port's `posgather_conv` span (the posgather conv with its
fused epilogue), device ms a scan of the traced batches
(benchmark/program_spans.py)."""

from benchmark.program_spans import per_scan


def read(rec):
    return per_scan("posgather_conv")
