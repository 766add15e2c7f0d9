"""The port's memory ensembles (findnpropagate_torch/utils/
memory_ensemble.py), its boxes_iou3d (ops/rotated_iou.py) and its
recall_record (models/post_processing.py) against the JAX package's on the
CPU.

The ensembles are numpy on both sides over the two packages' 3D IoU: equal
outputs. boxes_iou3d agrees within 1e-5 (f32, the same branch-free
24-candidate clip on both sides); recall_record's counts are equal. Every
case of tests/test_memory_ensemble.py runs through both packages."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_tpu.models.post_processing import (
    recall_record as jax_recall_record,
)
from findnpropagate_tpu.ops.rotated_iou import boxes_iou3d as jax_iou3d
from findnpropagate_tpu.utils import memory_ensemble as jme
from findnpropagate_torch.models.post_processing import recall_record
from findnpropagate_torch.ops.rotated_iou import boxes_iou3d
from findnpropagate_torch.utils import memory_ensemble as tme
from test_memory_ensemble import CFG, box, infos

IOU_ATOL = 1e-5


def random_boxes(rng, n, spread=8.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("seed", range(3))
def test_boxes_iou3d_matches_reference(seed):
    rng = np.random.RandomState(seed)
    a = random_boxes(rng, 40)
    b = np.concatenate([random_boxes(rng, 30), a[:5],
                        a[5:10] + np.float32([0.3, -0.2, 0.1, 0, 0, 0, 0.2])])
    got = boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_iou3d(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=IOU_ATOL, rtol=0)
    np.testing.assert_allclose(np.diag(got[:5, 30:35]), 1.0, atol=1e-5)
    assert (got[:, :30] > 0).any() and (got == 0).any()


# ------------------------------------------------------------- ensembles

def same_infos(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def run_both(fn_name, a, b, cfg):
    """The port's and the reference's ensemble on deep copies of the same
    inputs (the reference writes into its arguments)."""
    got = getattr(tme, fn_name)(copy.deepcopy(a), copy.deepcopy(b), cfg,
                                device="cpu")
    want = getattr(jme, fn_name)(copy.deepcopy(a), copy.deepcopy(b), cfg)
    same_infos(got, want)
    return got


def test_consistency_keeps_higher_confidence():
    out = run_both("consistency_ensemble", infos([box(10, 0, 0.5)]),
                   infos([box(10.2, 0, 0.9)]), CFG)
    assert len(out["gt_boxes"]) == 1 and out["memory_counter"][0] == 0
    assert out["gt_boxes"][0, 8] == np.float32(0.9)


@pytest.mark.parametrize("counter,kept", [(1, 2), (2, 1)])
def test_consistency_appear_disappear_and_remove(counter, kept):
    out = run_both("consistency_ensemble",
                   infos([box(10, 0, 0.8)], counter=[counter]),
                   infos([box(40, 0, 0.7)]), CFG)
    assert len(out["gt_boxes"]) == kept
    assert (out["gt_boxes"][:, 7] == -1).sum() == kept - 1


def test_nms_ensemble_dedups():
    out = run_both("nms_ensemble", infos([box(10, 0, 0.5)]),
                   infos([box(10.1, 0, 0.9), box(40, 0, 0.6)]), CFG)
    assert len(out["gt_boxes"]) == 2
    assert np.max(out["gt_boxes"][:, 8]) == np.float32(0.9)


def test_bipartite_matches_one_to_one():
    out = run_both("bipartite_ensemble",
                   infos([box(10, 0, 0.5), box(10.5, 0, 0.4)]),
                   infos([box(10.1, 0, 0.9)]), CFG)
    assert (out["memory_counter"] == 1).sum() == 1
    assert (out["gt_boxes"][:, 8] == np.float32(0.9)).sum() == 1


def rounds(seed, n_a, n_b, scores=False):
    """Two rounds of pseudo labels of one frame: the memory, and the new
    round with some boxes moved a little, some gone, some new."""
    rng = np.random.RandomState(seed)
    a = np.zeros((n_a, 9), np.float32)
    a[:, :7] = random_boxes(rng, n_a, spread=20.0)
    a[:, 7] = rng.randint(1, 11, n_a)
    a[:, 8] = rng.uniform(0.1, 1.0, n_a)
    keep = rng.uniform(size=n_a) < 0.7
    b = a[keep].copy()
    b[:, :2] += rng.normal(0, 0.3, (len(b), 2)).astype(np.float32)
    b[:, 8] = rng.uniform(0.1, 1.0, len(b))
    extra = np.zeros((n_b, 9), np.float32)
    extra[:, :7] = random_boxes(rng, n_b, spread=20.0)
    extra[:, 7] = rng.randint(1, 11, n_b)
    extra[:, 8] = rng.uniform(0.1, 1.0, n_b)
    b = np.concatenate([b, extra])

    def pack(boxes, counter):
        return {"gt_boxes": boxes,
                "cls_scores": boxes[:, 8].copy() if scores else None,
                "iou_scores": boxes[:, 8] * 0.5 if scores else None,
                "memory_counter": counter}
    return (pack(a, rng.randint(0, 3, n_a)),
            pack(b, np.zeros(len(b), np.int64)))


CFGS = {
    "consistency": dict(CFG, NAME="consistency_ensemble"),
    "consistency_weighted": dict(CFG, NAME="consistency_ensemble",
                                 WEIGHTED=True),
    "nms": dict(CFG, NAME="nms_ensemble"),
    "bipartite": dict(CFG, NAME="bipartite_ensemble"),
    "no_voting": {"NAME": "consistency_ensemble", "IOU_THRESH": 0.1},
}


@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("seed,n_a,n_b", [(0, 12, 4), (1, 30, 10),
                                          (2, 0, 5), (3, 6, 0)])
def test_memory_ensemble_dispatch_matches_reference(cfg, seed, n_a, n_b):
    a, b = rounds(seed, n_a, n_b, scores=cfg.startswith("consistency"))
    if seed == 3:                      # the new round found nothing
        b = {k: (v[:0] if v is not None else None) for k, v in b.items()}
    got = tme.memory_ensemble(copy.deepcopy(a), copy.deepcopy(b),
                              CFGS[cfg], device="cpu")
    same_infos(got, jme.memory_ensemble(copy.deepcopy(a), copy.deepcopy(b),
                                        CFGS[cfg]))


def test_ensembles_leave_their_arguments_alone():
    """The reference writes the ignore label into its caller's gt_boxes
    and the bumped counter into its caller's dict; the port does not."""
    for name in ("consistency_ensemble", "nms_ensemble",
                 "bipartite_ensemble"):
        for n_b in (3, 0):
            a, b = rounds(5, 10, n_b)
            if n_b == 0:
                b = {k: (v[:0] if v is not None else None)
                     for k, v in b.items()}
            a["memory_counter"][:] = 2
            a0, b0 = copy.deepcopy(a), copy.deepcopy(b)
            tme.memory_ensemble(a, b, dict(CFG, NAME=name), device="cpu")
            same_infos(a, a0)
            same_infos(b, b0)


# ----------------------------------------------------------------- recall

def recall_case(seed, n_det=20, n_gt=12):
    rng = np.random.RandomState(seed)
    gt = np.zeros((n_gt + 4, 8), np.float32)          # 4 padding rows
    gt[:n_gt, :7] = random_boxes(rng, n_gt, spread=15.0)
    gt[:n_gt, 7] = rng.randint(1, 11, n_gt)
    det = np.zeros((n_det, 7), np.float32)
    hit = min(n_det, n_gt)
    det[:hit] = gt[:hit, :7] + rng.normal(0, 0.3, (hit, 7)).astype(
        np.float32) * np.float32([1, 1, 0.5, 0.3, 0.3, 0.3, 0.2])
    det[hit:] = random_boxes(rng, n_det - hit, spread=15.0)
    mask = rng.uniform(size=n_det) < 0.8
    return det, mask, gt


@pytest.mark.parametrize("known", [None, (1, 2, 3, 4, 5, 6)])
@pytest.mark.parametrize("seed,n_det", [(0, 20), (1, 8), (2, 0)])
def test_recall_record_counts_match_reference(seed, n_det, known):
    det, mask, gt = recall_case(seed, n_det)
    got = recall_record(torch.from_numpy(det), torch.from_numpy(mask),
                        torch.from_numpy(gt), known_labels=known)
    want = jax_recall_record(jnp.asarray(det), jnp.asarray(mask),
                             jnp.asarray(gt), known_labels=known)
    assert set(got) == set(want)
    for k in want:
        assert int(got[k]) == int(want[k]), k
    if n_det:
        assert int(got["recall_0.3"]) > 0
