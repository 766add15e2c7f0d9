"""Process start -> the window's start: interpreter and torch import, the
kernels' build or load, weights, scenes and the warm-up of every batch."""


def read(rec):
    return rec["setup_s"]
