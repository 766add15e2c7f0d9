"""What the ported probes share: the device option, timing on the card,
the exact checks, and the rule that a failed or wrong variant makes the
probe exit non-zero."""

from __future__ import annotations

import argparse
import traceback

import numpy as np
import torch

from ..utils import timing


def parser(doc):
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: on the CPU the kernels' "
                    "plain versions run and nothing is timed")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per timing loop")
    return ap


def device_of(args):
    """The device named, else CUDA; None (after a message) when CUDA is
    missing and no device was named: the probe then exits with 2."""
    if args.device is not None:
        return torch.device(args.device)
    if not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run the plain versions "
              "on the CPU", flush=True)
        return None
    return torch.device("cuda")


def fmt_ms(t):
    return "not measured" if t is None else f"{t:9.4f} ms"


def same(a, b):
    """Equal shapes and values, NaN equal to NaN (bf16 exact in f32)."""
    a = a.float().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.float().cpu().numpy() if isinstance(b, torch.Tensor) else b
    return a.shape == b.shape and bool(np.array_equal(a, b, equal_nan=True))


def bf16_close(out, ref, rtol=1e-3):
    """(ok, max abs error): bf16 outputs of f32 sums taken in another order
    than the reference's agree within rtol of the reference's scale plus one
    bf16 step of each element (the final rounding may fall either way)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = rtol * max(float(ref.abs().max()), 1e-3) + ref.abs() * 2.0 ** -7
    return (out.shape == ref.shape and bool((err <= tol).all())
            and bool(torch.isfinite(out).all())), float(err.max())


def take_along_ref(x, idx, axis):
    """numpy take_along_axis with jnp's fill: indices count from the end
    when negative, NaN out of range; idx broadcasts on the other axis."""
    x = np.asarray(x, np.float32)
    idx = np.asarray(idx, np.int64)
    n = x.shape[axis]
    idx = np.where(idx < 0, idx + n, idx)
    g = np.take_along_axis(x, np.clip(idx, 0, n - 1), axis)
    return np.where((idx >= 0) & (idx < n), g, np.nan)


class Probe:
    """Runs variants, prints one line each, and remembers the ones that
    raised or came out wrong."""

    def __init__(self, device, reps):
        self.device, self.reps, self.failed = device, reps, []

    def time(self, fn, graph=True):
        """(ms, device ms) per call on the card, (None, None) on the CPU;
        device ms only where fn can be captured in a CUDA graph."""
        if self.device.type != "cuda":
            return None, None
        return (timing.ms(fn, self.reps),
                timing.device_ms(fn, self.reps) if graph else None)

    def run(self, name, fn, check, graph=True):
        """fn() checked by check(out) -> bool or (bool, error), then timed;
        returns the output, None where it failed."""
        try:
            out = fn()
            ok = check(out)
            err = None
            if isinstance(ok, tuple):
                ok, err = ok
            t, d = self.time(fn, graph)
        except Exception as e:   # a failed launch: report and carry on
            traceback.print_exc()
            print(f"{name:40s}: FAILED {type(e).__name__}: {e}", flush=True)
            self.failed.append(name)
            return None
        extra = "" if err is None else f" max err {err:.3g}"
        print(f"{name:40s}: {fmt_ms(t)}  device {fmt_ms(d)}  "
              f"correct={ok}{extra}", flush=True)
        if not ok:
            self.failed.append(name)
        return out

    def line(self, name, fn, graph=True):
        """A timed call with no check of its own (a library yardstick)."""
        t, d = self.time(fn, graph)
        print(f"{name:40s}: {fmt_ms(t)}  device {fmt_ms(d)}", flush=True)

    def exit_code(self):
        if self.failed:
            print(f"FAILED: {', '.join(self.failed)}", flush=True)
            return 1
        return 0
