"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with narrow configurations and small traffic, where a whole run fits on the
CPU. The `chip` marker is for tests that need an H100; they decide so in
a fixture and skip on a machine without CUDA."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
# a whole narrow run a test: few threads, so that workers do not contend
torch.set_num_threads(2)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

NARROW_DATA = {"POINT_CLOUD_RANGE": [-12.0, -12.0, -5.0, 12.0, 12.0, 3.0],
               "MAX_POINTS": 30000, "MAX_VOXELS": 6000}
NARROW_MODEL = {
    "BACKBONE_3D": {"MAX_VOXELS": 6000, "CHANNELS": [16, 16, 16, 16, 16],
                    "OUT_CHANNELS": 16, "WINDOWED_BLOCK": 512,
                    "LEVEL_CAPACITIES": [6144, 6144, 6144, 2048, 1024]},
    "BACKBONE_2D": {"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                    "NUM_UPSAMPLE_FILTERS": [16, 16]},
    "DENSE_HEAD": {"HIDDEN_CHANNEL": 32, "NUM_HEADS": 2, "FFN_CHANNEL": 64,
                   "NUM_PROPOSALS": 20},
    "IMAGE_BACKBONE": {"EMBED_DIMS": 16, "DEPTHS": [1, 1, 1, 1],
                       "NUM_HEADS": [1, 2, 4, 8]},
    "NECK": {"IN_CHANNELS": [32, 64, 128], "OUT_CHANNELS": 32},
    "VTRANSFORM": {"IMAGE_SIZE": [64, 176], "IN_CHANNEL": 32,
                   "OUT_CHANNEL": 16, "FEATURE_SIZE": [8, 22],
                   "XBOUND": [-12.0, 12.0, 0.3], "YBOUND": [-12.0, 12.0, 0.3],
                   "DBOUND": [1.0, 30.0, 1.0]},
    "FUSER": {"IN_CHANNEL": 48, "OUT_CHANNEL": 32},
}
NARROW_TRAFFIC = {"batch": 2, "pool": 4, "points": 20000, "objects": 8,
                  "check_batches": 2, "check_among": 3, "check_scenes": 1}


def narrow_config(config):
    """A configuration at the narrow width and on the cropped scene."""
    config["DATA"].update(NARROW_DATA)
    if "CAMERA" in config["DATA"]:
        config["DATA"]["CAMERA"]["IMAGE_SIZE"] = [64, 176]
    for key, vals in NARROW_MODEL.items():
        if key in config:
            config[key].update(vals)
    return config


def make_narrow_root(tmp_path):
    """Fill `tmp_path` with BENCHMARK.json and the benchmark's data files,
    its configurations narrowed and its traffic small."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "loops", "detectors"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    for path in (bench / "configs").glob("*.json"):
        path.write_text(json.dumps(narrow_config(json.loads(
            path.read_text()))))
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(NARROW_TRAFFIC)
        path.write_text(json.dumps(t))
    return tmp_path


@pytest.fixture
def narrow_root(tmp_path):
    return make_narrow_root(tmp_path)


@pytest.fixture
def cuda():
    """The test needs an H100: skip without CUDA."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return torch.device("cuda")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA H100; skips without CUDA")
