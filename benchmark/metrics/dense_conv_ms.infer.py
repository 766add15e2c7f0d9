"""The port's `dense_conv` span: the dense levels' F.conv3d with their
masked BN and ReLU, device ms a scan of the traced batches
(benchmark/program_spans.py)."""

from benchmark.program_spans import per_scan


def read(rec):
    return per_scan("dense_conv")
