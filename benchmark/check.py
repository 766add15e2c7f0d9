"""How `correct` is decided: the timed path's outputs against the plain
reference (reference/), batch by batch, after the window.

The configuration's adapter (detectors/<detector>.py) computes the numbers
of each checked batch, the reference running in float32 with TF32 off on
the same inputs and weights; its docstring says what each number is.
`limits` come from the configuration file; `correct` holds where every
number that has a limit there is within it; the others are reported as
readings.
"""

from __future__ import annotations


def rel(p, r):
    """||p - r|| / ||r||, in float32."""
    return float((p.float() - r.float()).norm()
                 / r.float().norm().clamp_min(1e-30))


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}, {name: value}): the numbers
    that the configuration gives a limit, and the rest as readings. A limit
    on a number the adapter does not compute is an error."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"limits on numbers that are not computed: {missing}")
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in numbers.items() if k in limits}
    readings = {k: v for k, v in numbers.items() if k not in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks, readings
