"""The harness on the CPU: cells, configurations, traffic, loops, detector
adapters and metrics found by name, a cell added by files alone, BENCHMARK.json within the contract's
characters and keys, the work counters against hand counts, and what the
harness and the reference load."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import harness, work
from benchmark.reference import sparse
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(HIDDEN|INTERMEDIATE|LATENT|STATE|PROJECTION|_DIM$|"
                   r"_RANK$|HEAD|EXPANSION|EXPERTS_PER|CHANNEL|FILTERS|"
                   r"EMBED)", re.I)
SPEC = harness.load_spec()
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_spec_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(text_ok(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    names = []
    for key, allowed in ENTRY_KEYS.items():
        for e in SPEC[key]:
            assert set(e) <= allowed, (key, e["name"])
            assert set(e) >= allowed - {"workloads"}, (key, e["name"])
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer"):
                if k in e:
                    assert text_ok(e[k]), (e["name"], k)
            if key == "configs":
                assert text_ok(e["source"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_finds_every_config_traffic_and_metric_by_name():
    for w in SPEC["workloads"]:
        cell, config, traffic = harness.find_cell(SPEC, w["name"])
        assert cell is not None
        assert callable(harness.module("loops", traffic["loop"]).window)
        assert callable(harness.module("detectors", config["detector"])
                        .compare_batch)
        assert config["DATA"]["POINT_CLOUD_RANGE"]
        assert set(config["limits"]) >= {"actives", "bev_err", "pick_miss", "query_err", "decode_err"}
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.parts[len(ROOT.parts)] == "benchmark"
        assert json.loads(path.read_text())["source"] == c["source"]
        assert len(c["source"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_layer_metric_cell_reports_what_it_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        got = [m for m in SPEC["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert any(m["name"] == "setup_s" for m in got)
        assert len(got) >= 2, w["name"]
        assert harness.cell_metrics(SPEC, w["name"], True), w["name"]
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"], \
                (m["name"], cell)
    for m in SPEC["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_cell_is_added_by_files_alone(narrow_root):
    """A new configuration with its own detector adapter, a traffic mix
    with its own loop, and a metric, as files and entries in
    BENCHMARK.json: the harness runs the new cell unchanged."""
    bench = narrow_root / "benchmark"
    cfg = json.loads((bench / "configs" / "transfusion_lidar.json")
                     .read_text())
    cfg["detector"] = "dummy_det"
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (bench / "detectors" / "dummy_det.py").write_text(textwrap.dedent(
        '''
        from benchmark.detectors.transfusion import *  # noqa: F401,F403
        from benchmark.detectors import transfusion

        def compare_batch(*args):
            return dict(transfusion.compare_batch(*args), dummy_det=1.0)
        '''))
    cell = SPEC["workloads"][0]
    mix = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    mix.update(batch=1, pool=2, check_batches=1, check_among=2,
               loop="dummy_loop")
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "loops" / "dummy_loop.py").write_text(textwrap.dedent(
        '''
        from benchmark.loops.closed import inputs, warm_up
        from benchmark.loops.closed import window as closed_window

        def window(*args, **kwargs):
            rec, caps, prof = closed_window(*args, **kwargs)
            rec["dummy_loop"] = True
            return rec, caps, prof
        '''))
    (bench / "metrics" / "dummy_scans.infer.py").write_text(textwrap.dedent(
        '''
        def read(rec):
            assert rec["dummy_loop"]
            return float(rec["scans"])
        '''))
    spec = json.loads((narrow_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "a test",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_mix",
                              "config": "dummy_cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "dummy_scans.infer", "unit": "scans",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "setup_s",
                              "workloads": ["dummy_cfg.dummy_mix"]})
    (narrow_root / "BENCHMARK.json").write_text(json.dumps(spec))
    torch.manual_seed(0)
    result, lines = harness.run_cell("dummy_cfg.dummy_mix", 2 ** 31 + 7, 0.5,
                                     True, 0.0, narrow_root, device="cpu")
    assert result["correct"], lines
    assert result["metrics"]["dummy_scans.infer"]["value"] \
        == result["attempted"]
    assert "voxelize_ms.infer" not in result["metrics"]
    assert result["readings"]["dummy_det"] == 1.0
    assert list(result)[-1] == "checks"


def test_an_unknown_loop_or_detector_is_refused(narrow_root):
    cell = SPEC["workloads"][0]
    path = narrow_root / "benchmark" / "traffic" / f"{cell['traffic']}.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, loop="open")))
    with pytest.raises(FileNotFoundError, match="open"):
        harness.run_cell(cell["name"], 1, 0.1, False, 0.0, narrow_root,
                         device="cpu")
    path.write_text(json.dumps(mix))
    path = narrow_root / next(c["file"] for c in SPEC["configs"]
                              if c["name"] == cell["config"])
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    detector="centerpoint")))
    with pytest.raises(FileNotFoundError, match="centerpoint"):
        harness.run_cell(cell["name"], 1, 0.1, False, 0.0, narrow_root,
                         device="cpu")


@pytest.mark.parametrize("level, out_bytes", [(2, 4), (4, 2)])
def test_work_counters_against_hand_counts(level, out_bytes):
    """A conv onto a sparse level reads bf16 and writes float32; onto a
    dense level (above DENSE_FROM_LEVEL 3) it writes bf16."""
    book = [{"hits": 10, "cin": 16, "cout": 32, "taps": 27, "n_in": 5,
             "n_out": 4, "level": level}]
    flops, bound = work.sparse_work(book, 3)
    assert flops == 2 * 10 * 16 * 32
    nbytes = 2 * (5 * 16 + 27 * 16 * 32) + out_bytes * 4 * 32
    assert bound == max(flops / work.PEAK_FLOPS, nbytes / work.PEAK_BYTES)

    counter = work.WorkCounter()
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    up = torch.nn.ConvTranspose2d(8, 4, 2, 2, bias=False)
    lin = torch.nn.Linear(6, 5)
    x = torch.randn(2, 3, 5, 7)
    with torch.no_grad(), counter:
        counter.layer = "conv"
        y = conv(x)
        counter.layer = "up"
        up(y)
        counter.layer = "linear"
        lin(torch.randn(4, 6))
    assert counter.flops["conv"] == 2 * (2 * 8 * 5 * 7) * (3 * 9)
    assert counter.flops["up"] == 2 * (2 * 8 * 5 * 7) * (4 * 4)
    assert counter.flops["linear"] == 2 * 4 * 6 * 5


def test_sparse_rulebook_hits_by_hand():
    """Two voxels side by side in x: a 3x3x3 submanifold conv has 4 hits
    (each its own centre and the other); one voxel strided onto a grid half
    as fine has one hit."""
    conv = sparse.SparseConvParam(1, 1)
    coords = torch.tensor([[1, 1, 1], [1, 1, 2]])
    lv = sparse.Level(coords, torch.ones(2, 1), (3, 3, 4))
    book = []
    sparse.sparse_conv(lv, coords, conv, (1, 1, 1), (1, 1, 1), None, book)
    assert book[0]["hits"] == 4
    out, cut = sparse.strided_active_set(
        sparse.Level(coords[:1], torch.ones(1, 1), (3, 3, 4)), (2, 2, 2),
        (3, 3, 3), (2, 2, 2), (1, 1, 1), None)
    assert not cut
    # cell (1, 1, 1) reaches the outputs o with 2 o + t - 1 = 1, t in 0..2
    assert sorted(map(tuple, out.tolist())) == [
        (z, y, x) for z in (0, 1) for y in (0, 1) for x in (0, 1)]


LOADED = textwrap.dedent('''
    import json, sys, time
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    import conftest, tempfile
    from pathlib import Path
    from benchmark import harness
    root = conftest.make_narrow_root(Path(tempfile.mkdtemp()))
    harness.run_cell({cell!r}, 5, 0.2, False, 0.0, root, device="cpu")
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
''')


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", LOADED.format(
            root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"),
            cell=SPEC["workloads"][0]["name"])], capture_output=True, text=True,
        timeout=600, check=True)
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import benchmark.reference.model, benchmark.check, "
            "benchmark.work, benchmark.weights, benchmark.scenes, "
            "benchmark.inputs, benchmark.detectors.transfusion; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & {"findnpropagate_torch", *harness.FORBIDDEN}


def test_run_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
