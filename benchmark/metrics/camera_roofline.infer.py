"""The camera branch's bound (work.py: its matrix products' and
convolutions' operations and bytes against the bf16 peak and HBM
bandwidth), summed over the window's scans, over its measured span, in
%."""


def read(rec):
    ms = rec.get("span_ms", {}).get("camera")
    bound = rec.get("work", {}).get("camera_bound_ms")
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
