"""Build and load the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use for ``sm_90a`` into
``build/kernels/lib<name>_<source hash>.so`` at the root of the checkout
(listed in .gitignore); the hash covers the source and every header under
``csrc/`` that it includes, so a change to any of them is rebuilt and
unchanged sources are reused. `build_all` starts one nvcc per source at once and waits for
all. Nothing here runs at import time: this module imports on machines
without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
BUILD_SECONDS: dict = {}   # name -> seconds its nvcc took in this process
PTXAS_LOG: dict = {}       # name -> nvcc's stderr (registers, smem, spills)


def _nvcc():
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(src):
    """The source and, recursively, the files under csrc/ that it includes
    with quotes, in the order met."""
    files, todo = [], [Path(src)]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        for inc in _INCLUDE.findall(f.read_text()):
            if (f.parent / inc).exists():
                todo.append(f.parent / inc)
    return files


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for f in source_files(src):
        h.update(f.read_bytes())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def spills(ptxas_log):
    """{mangled kernel name: bytes of register spills (stores + loads)}
    from the report that ``-Xptxas -v`` writes."""
    out, fn = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out[fn] = int(m.group(1)) + int(m.group(2))
            fn = None
    return out


def build_all(names):
    """Compile every named source that has no up-to-date library, one nvcc
    process each, all at once. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS_LOG[name] = err
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}\n{err}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name):
    """The ctypes library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)[1]))
    return _LIBS[name]


def check(status, what):
    """Raise if a C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
