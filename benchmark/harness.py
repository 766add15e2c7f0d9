"""One run of one cell: the cell, its configuration, traffic, loop,
detector adapter and metrics found by name, then set-up, the measured
window, the check and the result.

A cell of BENCHMARK.json names a configuration (its `file`, a JSON object
under configs/) and a traffic mix (traffic/<traffic>.json). The
configuration names its detector adapter (`"detector"`:
detectors/<detector>.py: the reference, the hooks on the port, the control,
the comparison, the counted work); the mix names its loop (`"loop"`:
loops/<loop>.py: the inputs, the warm-up and the measured window). Each
metric is read by metrics/<name>.py, whose `read(record)` returns the
number or None (then the metric is left out of the result). Adding a cell,
a mix, a loop, a detector or a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .check import verdict
from .sides import PortSide
from .weights import random_state

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "findnpropagate_tpu")


# ---- finding things by name -------------------------------------------


def load_spec(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(spec, name, root=ROOT):
    """(workload entry, configuration, traffic) of cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((Path(root) / configs[cell["config"]]["file"])
                        .read_text())
    traffic = json.loads((Path(root) / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def cell_metrics(spec, name, trace):
    """The metric entries a run of cell `name` reports: the end-to-end ones
    without --trace, the per-layer ones with it."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or name in m["workloads"]]


def module(kind, name, root=ROOT):
    """benchmark/<kind>/<name>.py of the checkout at `root`, loaded from
    its path: a metric's reader, a loop or a detector adapter."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name, root=ROOT):
    """metrics/<name>.py's `read`."""
    return module("metrics", name, root).read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---- the run ------------------------------------------------------------


def check_picks(traffic, seed, check_among=None):
    """The checked batches, drawn from the seed: `check_batches` of the
    window's first `check_among`."""
    among = int(check_among or traffic["check_among"])
    n = min(int(traffic["check_batches"]), among)
    rng = np.random.default_rng([int(seed), 1])
    return set(int(p) for p in rng.choice(among, n, replace=False))


def compare(adapter, ref, inputs, caps, traffic, seed):
    """The numbers of the checked batches, each the worst over them: in
    each batch, `check_scenes` of its scenes drawn from the seed (all of
    them without that key)."""
    b = inputs.scenes_per_batch
    n = min(int(traffic.get("check_scenes", b)), b)
    rng = np.random.default_rng([int(seed), 2])
    numbers = {}
    for i, cap in sorted(caps.items()):
        scenes = sorted(int(j) for j in rng.choice(b, n, replace=False))
        got = adapter.compare_batch(ref, inputs.to_device(i), cap, scenes)
        numbers = {k: max(v, numbers.get(k, 0.0)) for k, v in got.items()}
    return numbers


def run_cell(name, seed, seconds, trace, t_start, root=ROOT, device=None,
             side="port", check_among=None):
    """One run of cell `name`: (result dict, check lines). `t_start` is the
    host clock at the process's start, so set-up counts from there. `side`
    "control" puts the adapter's control in the port's place;
    `check_among` overrides the mix's (calibrate.py)."""
    device = torch.device(device or "cuda")
    parts, mark = {}, [t_start]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    part("interpreter_and_imports")
    spec = load_spec(root)
    cell, config, traffic = find_cell(spec, name, root)
    adapter = module("detectors", config["detector"], root)
    loop = module("loops", traffic["loop"], root)
    state = random_state(adapter.reference(config), seed, device)
    part("weights")
    inputs = loop.inputs(config, traffic, seed, device)
    part("scenes")
    sut = PortSide(config, state, device, adapter) if side == "port" \
        else adapter.Control(config, state, device)
    part("build")
    loop.warm_up(sut, inputs, device, trace)
    part("warm_up")
    setup_s = time.perf_counter() - t_start

    picks = check_picks(traffic, seed, check_among)
    spans = sut.trace() if trace else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec, caps, prof = loop.window(
        sut, inputs, seconds, picks, device, adapter.failed, spans,
        (seconds / 3, min(1.5, seconds / 3)) if trace else None)
    rec["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if spans is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["span_ms"] = spans.totals_ms()
    sut.close()
    del sut
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = adapter.reference(config, state, device)
    numbers = compare(adapter, ref, inputs, caps, traffic, seed)
    ok, checks, readings = verdict(numbers, config["limits"])

    result = {"correct": bool(ok and rec["failed"] == 0),
              "attempted": rec["scans"], "failed": rec["failed"]}
    breakdown = None
    if trace:
        rec["work"] = adapter.work(ref, inputs, device, rec["batches"],
                                   config)
        if prof is not None:
            from .trace import reduce_profile

            rec["busy_s"], breakdown = reduce_profile(prof, rec["profiled_s"])
    metrics = {}
    for m in cell_metrics(spec, name, trace):
        v = reader(m["name"], root)(rec)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = rec.get("busy_s", 0.0)
        dev["window_s"] = rec["profiled_s"]
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts_s"] = parts
    result["readings"] = readings
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines
