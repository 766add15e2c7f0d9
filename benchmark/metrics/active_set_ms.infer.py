"""The port's `active_set` span: the sparse backbone's sorted active
sets (the entry's sort, each strided level's downsample and base ids),
device ms a scan of the traced batches (benchmark/program_spans.py)."""

from benchmark.program_spans import per_scan


def read(rec):
    return per_scan("active_set")
