"""The port's `image_backbone` span (Swin-T over the six images), device
ms a scan of the traced batches (benchmark/program_spans.py)."""

from benchmark.program_spans import per_scan


def read(rec):
    return per_scan("image_backbone")
