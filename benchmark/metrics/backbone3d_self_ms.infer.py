"""The port's `backbone_3d` span less its children (active sets, K1, K2,
dense convs): the unfused bias, mask, BN, ReLU and residual tails, the
grids and the layout copies; device ms a scan of the traced batches
(benchmark/program_spans.py)."""

from benchmark.program_spans import per_scan


def read(rec):
    return per_scan("backbone_3d", "self_ms")
