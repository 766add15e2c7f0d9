"""1 - (the union of the device's activity intervals) / (the profiled
stretch of the window), in %."""


def read(rec):
    if not rec.get("profiled_s") or "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["profiled_s"])
