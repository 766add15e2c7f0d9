"""Scans whose detections reached the host in the window, over the
window's seconds (first batch due -> last batch back)."""


def read(rec):
    return rec["scans"] / rec["window_s"]
