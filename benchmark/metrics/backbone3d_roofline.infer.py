"""The sparse backbone's bound (work.py: its convolutions' rulebook
operations and bytes against the bf16 peak and HBM bandwidth), summed over
the window's batches, over its measured span, in %."""


def read(rec):
    ms = rec.get("span_ms", {}).get("backbone3d")
    if not ms:
        return None
    return 100.0 * rec["work"]["backbone3d_bound_ms"] / ms
