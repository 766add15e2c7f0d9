"""`correct` must come out false where the timed path is wrong.

On the CPU: a whole run of each cell at a narrow width, with the port's
path broken underneath the harness, once for each fault an inference cell
can have: an answer altered where it is produced (one detection's box),
and half of the batch left out (its scenes replaced by the other half's).

On the chip (marked `chip`, skipped without CUDA): the control, the
reference one precision step below the configuration's in the port's
place (reference/precision.py), at the cell's own size on three seeds,
reads not correct on every seed. Run it there with
    python3 -m pytest benchmark/tests -m chip -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, sides
from benchmark.calibrate import main as calibrate

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def altered_answer(infer):
    def run(self, batch, capture=False):
        dets, cap = infer(self, batch, capture)
        dets.boxes[0, 0, 0] += 0.5
        return dets, cap
    return run


def half_batch(infer):
    def run(self, batch, capture=False):
        b = batch["points"].shape[0]
        half = {k: torch.cat([v[:b // 2]] * 2) if v.shape[0] == b else v
                for k, v in batch.items()}
        return infer(self, half, capture)
    return run


@pytest.mark.parametrize("fault", [altered_answer, half_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(narrow_root, monkeypatch, cell,
                                      fault):
    monkeypatch.setattr(sides.PortSide, "infer",
                        fault(sides.PortSide.infer))
    torch.manual_seed(0)
    result, lines = harness.run_cell(cell, 424242, 0.5, False, 0.0,
                                     narrow_root, device="cpu")
    assert not result["correct"], lines


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cuda, cell):
    rows = calibrate(["--workload", cell, "--side", "control", "--seeds",
                      "71,72,73", "--seconds", "1"])
    assert rows and not any(r["correct"] for r in rows), rows
