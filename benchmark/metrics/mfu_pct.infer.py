"""The counted operations of every batch of the window (work.py: the
sparse convolutions' rulebook and the dense layers' products) over the
window's seconds, against the bf16 dense peak of 989 TFLOP/s, in %."""

from benchmark.work import PEAK_FLOPS


def read(rec):
    if "work" not in rec:
        return None
    return 100.0 * rec["work"]["flops"] / (rec["window_s"] * PEAK_FLOPS)
