"""The readers of the port's own spans (benchmark/program_spans.py and the
seven `program_span` metrics) on the CPU: a traced run of each narrow cell
reports each reader its cells list, finite and above 0, and the spans come
from the batches the profiler recorded; untraced, and on a checkout whose
program has no spans, every reader gives None."""

from __future__ import annotations

import math
import sys

import pytest
import torch

from benchmark import harness

SPEC = harness.load_spec()
SPAN_METRICS = {m["name"]: m for m in SPEC["per_layer"]
                if m["source"] == "program_span"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_the_seven_readers_are_declared():
    assert sorted(SPAN_METRICS) == sorted([
        "positions_ms.infer", "posgather_conv_ms.infer",
        "active_set_ms.infer", "dense_conv_ms.infer",
        "backbone3d_self_ms.infer", "image_backbone_ms.infer",
        "bev_pool_ms.infer"])
    for m in SPAN_METRICS.values():
        assert (m["unit"], m["better"], m["moves"]) == \
            ("ms/scan", "lower", "scans_per_s")


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_span_readers(narrow_root, cell):
    from findnpropagate_torch.utils import trace

    trace.reset()
    torch.manual_seed(0)
    result, lines = harness.run_cell(cell, 2 ** 31 + 11, 0.5, True, 0.0,
                                     narrow_root, device="cpu")
    assert result["correct"], lines
    got = result["metrics"]
    for name, m in SPAN_METRICS.items():
        if cell in m["workloads"]:
            assert name in got, name
            assert math.isfinite(got[name]["value"]) \
                and got[name]["value"] > 0, (name, got[name])
            assert got[name]["unit"] == "ms/scan"
        else:
            assert name not in got, name
    tot = trace.totals()
    # the warm-up's profiled batch and at least one of the window's, each
    # of the narrow traffic's 2 scans
    assert 2 <= tot["batches"] <= result["attempted"] // 2 + 1
    assert tot["scans"] == 2 * tot["batches"]
    bb = tot["spans"]["backbone_3d"]
    assert got["backbone3d_self_ms.infer"]["value"] == pytest.approx(
        bb["self_ms"] / tot["scans"])
    assert bb["self_ms"] < bb["device_ms"]
    assert tot["spans"]["forward"]["calls"] == tot["batches"]
    assert tot["spans"]["decode"]["calls"] == tot["batches"]
    # the old readings are all still there
    for m in harness.cell_metrics(SPEC, cell, True):
        if m["source"] != "program_span":
            assert m["name"] in got, m["name"]


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_reader_gives_none_untraced_or_without_spans(name, monkeypatch):
    from findnpropagate_torch.utils import trace

    read = harness.reader(name)
    trace.reset()
    assert read({"scans": 64, "window_s": 1.0}) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("forward", scans=2):
            for span in ("positions", "posgather_conv", "active_set",
                         "dense_conv", "backbone_3d", "image_backbone",
                         "bev_pool"):
                with trace.span(span):
                    pass
    value = read({"scans": 64, "window_s": 1.0})
    assert value is not None and math.isfinite(value)
    # a program with no trace module (the parent of the spans)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "findnpropagate_torch.utils.trace", None)
        mp.delattr(sys.modules["findnpropagate_torch.utils"], "trace")
        assert read({"scans": 64, "window_s": 1.0}) is None
    trace.reset()
