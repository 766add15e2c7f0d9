"""Where the device time of the P2 / P3 window kernels goes on the card:
each kernel built again with one part cut out, timed beside the full one.

    python -m findnpropagate_torch.tools.probe_window_parts [--reps 20]

The window kernels of ops/csrc/gather_probes.cu, P3 (banded_gather_conv)
at band 3 and P2 with weights (onehot_gather) at tap_win 1536, at
probe_posgather.py's shapes (16 channels, a 2048-column window, 27 taps,
1024 targets, 118 blocks). Each cut below is made in a copy of the source,
built by nvcc with the port's flags into build/kernels/parts/ (all at
once), and timed from CUDA graphs in turns with the full kernel (full,
cut, cut, full); the difference is the part's share of the device time.
A cut changes the output, which is not checked:
  staging   the window rows and the weights are not staged;
  A         no ldmatrix of the gathered rows (their offsets stand in);
  B         no ldmatrix of the weights;
  products  no mma (the fragments are folded into one sum);
  stores    the results are not stored;
  math      A, B, products and stores together: staging, positions and
            the loop are left;
  search    (P2 only) no search: the wanted id modulo tap_win stands in
            for its rank.
One more line times the full P3 on rows that lie in one place a tap (rel
and starts 0), where every ldmatrix of the window is a broadcast: its
difference to the random rows is what their bank conflicts cost. Prints a
line per part and a JSON line of them all. Needs CUDA and nvcc; exits
with 2 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import gather_probes as gp
from ..utils import timing
from .probe_posgather import banded_inputs, onehot_inputs

CUTS = {
    "staging": [("""  stage_rows(smem, x, s, n_rows, tid);
  stage_weights(w_sm, w, taps, tid);""", "")],
    "A": [("""          fp::ldmatrix_x4(fa, win_sa + ((uint32_t)r ^ (half << 4)));"""
           ,
           """          fa[0] = r; fa[1] = r + 1; fa[2] = r + 2; fa[3] = r + 3;""")],
    "B": [("""        fp::ldmatrix_x4(fb, b_sa + (k_this + q) * kC * 2);""",
           """        fb[0] = q; fb[1] = q + 1; fb[2] = q + 2; fb[3] = q + 3;""")],
    "products": [("""          fp::mma_bf16(acc[mt][0], fa, fb[0], fb[1]);
          fp::mma_bf16(acc[mt][1], fa, fb[2], fb[3]);""",
                  """          acc[mt][0][0] += __uint_as_float(fa[0] ^ fa[1] ^ fa[2]
              ^ fa[3] ^ fb[0] ^ fb[1] ^ fb[2] ^ fb[3]);""")],
    "stores": [("""        store_tile(d, st_sa, st, out + (size_t)b * w_len + w0 + mt * 16, ld,
                   lane);""", """        if (d[0] == 0x12345678u && d[1] == 0x9abcdef0u)
          store_tile(d, st_sa, st, out + (size_t)b * w_len + w0 + mt * 16,
                     ld, lane);""")],
    "search": [("""        find_rows<kSearch>(ix, v, r);""",
                """        for (int i = 0; i < kSearch; ++i)
          r[i] = (int)((unsigned)v[i] % (unsigned)ix.n);""")],
}
CUTS["math"] = CUTS["A"] + CUTS["B"] + CUTS["products"] + CUTS["stores"]
P3_CUTS = ("staging", "A", "B", "products", "stores", "math")
P2_CUTS = P3_CUTS + ("search",)


def cut_source(src, name):
    """gather_probes.cu with cut `name` made; raises if the source no
    longer holds the text the cut replaces."""
    for old, new in CUTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"cut {name}: the source holds {src.count(old)}"
                             f" copies of {old.splitlines()[0]!r}")
        src = src.replace(old, new)
    return src


def build_cuts():
    """{cut: its ctypes library}, built all at once."""
    src = (_build.CSRC / "gather_probes.cu").read_text()
    out = _build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in CUTS:
        path = out / f"{name}.cu"
        path.write_text(cut_source(src, name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    full = gp._lib()
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cut {name}:\n{err}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for f in ("fp_onehot_gather", "fp_banded_gather_conv"):
            getattr(lib, f).argtypes = getattr(full, f).argtypes
            getattr(lib, f).restype = ctypes.c_int
        libs[name] = lib
    return full, libs


def full_and_cut(full, lib, call, reps):
    """(full ms, cut ms): device times from CUDA graphs taken in turns
    (`timing.in_turns`), each the mean of its two."""
    def with_lib(which):
        def run():
            gp._lib = lambda: which
            return timing.device_ms(call, reps)
        return run
    got = timing.in_turns(with_lib(full), with_lib(lib))
    return sum(got["before"]) / 2, sum(got["after"]) / 2


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per CUDA graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the window kernels' parts are timed on the "
              "card only", flush=True)
        return 2
    dev = torch.device("cuda")
    lib_of = gp._lib
    try:
        full, libs = build_cuts()
        c, w, taps, s, nb = 16, 1024, 27, 2048, 118
        p3 = banded_inputs(c, w, 3, taps, s, nb, dev)
        x, ids, want, wt = onehot_inputs(c, w, taps, s, dev)
        calls = {
            "P3": (lambda: gp.banded_gather_conv(*p3, 3), P3_CUTS),
            "P2": (lambda: gp.onehot_gather(x, ids, want, tap_win=1536,
                                            wt=wt, blocks=nb), P2_CUTS),
        }
        parts = {}
        for kernel, (call, cuts) in calls.items():
            for name in cuts:
                t_full, t_cut = full_and_cut(full, libs[name], call,
                                             args.reps)
                share = (t_full - t_cut) / t_full
                parts[f"{kernel} {name}"] = {
                    "full_ms": t_full, "cut_ms": t_cut, "share": share}
                print(f"{kernel} without {name:9s}: {t_cut:.4f} ms, full "
                      f"{t_full:.4f} ms: share {share:.3f}", flush=True)
        gp._lib = lambda: full
        one = (torch.zeros_like(p3[0]), p3[1], torch.zeros_like(p3[2]), p3[3])
        t_one = timing.device_ms(lambda: gp.banded_gather_conv(*one, 3),
                                 args.reps)
        t_rand = timing.device_ms(lambda: gp.banded_gather_conv(*p3, 3),
                                  args.reps)
        parts["P3 bank conflicts"] = {"full_ms": t_rand, "one_row_ms": t_one,
                                      "share": (t_rand - t_one) / t_rand}
        print(f"P3 rows in one place a tap: {t_one:.4f} ms, random "
              f"{t_rand:.4f} ms: conflicts' share "
              f"{parts['P3 bank conflicts']['share']:.3f}", flush=True)
    finally:
        gp._lib = lib_of
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"parts": parts, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
