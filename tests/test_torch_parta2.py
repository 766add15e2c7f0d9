"""Part-A2 of the PyTorch port against the JAX package end to end at
small size (tests/test_parta2_e2e.py's model on
tests/test_voxelrcnn_e2e.py's data, whose `slow` marks keep them out of
tier-1), on the same synthetic batch and weights: Part-A2 (UNetV2 in the
XLA windowed mode, anchor RPN, intra-part point head, ROI-aware part
aggregation), the same with the port in SUBM_IMPL posgather (blocks of
512, windows of 2048: on the CPU its K1-K4 wrappers run their plain
versions) against the same JAX run, and a PartA2_free-like model (NAME
PointRCNN, no dense head: the intra-part head's REG_FC boxes are the
proposals). The eval forward, the decoded detections, the training loss
with its tb and init_random_, by tests/test_torch_parta2_pointrcnn.py's
tests and tolerances over these runs.
"""

import pytest

import test_torch_parta2_pointrcnn as base
from test_torch_parta2_pointrcnn import (  # noqa: F401
    one_torch_thread,
    test_detections_match_jax,
    test_forward_matches_jax,
    test_init_random_matches_bench,
    test_loss_matches_jax,
)


@pytest.fixture(scope="module", params=["parta2", "parta2_posgather",
                                        "parta2_free"])
def detectors(request):
    return base.port_detector(request.param)
