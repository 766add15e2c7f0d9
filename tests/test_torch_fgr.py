"""The port's FGR proposer (findnpropagate_torch/openvocab/fgr.py) against
the JAX package's on the CPU: numpy on both sides, the same seeded inputs,
equal outputs. The port's region growing walks neighbour lists where the
reference computes a distance matrix per frontier; the seeded cases below
hold the two equal (rejected partial clusters, ratio None, float32 and
float64 clouds). Every case of tests/test_fgr.py runs through both."""

import numpy as np
import pytest

from findnpropagate_tpu.openvocab import fgr as jfgr
from findnpropagate_torch.openvocab import fgr as tfgr
from test_box_classification import project_box_2d
from test_fgr import _box_surface_points
from test_frustum_proposer import make_camera


def lshape(yaw=0.4, seed=0):
    rng = np.random.RandomState(seed)
    e1 = np.stack([np.linspace(0, 4, 60), np.zeros(60)], 1)
    e2 = np.stack([np.zeros(40), np.linspace(0, 2, 40)], 1)
    pts = np.concatenate([e1, e2]) + rng.normal(0, 0.01, (100, 2))
    c, s = np.cos(yaw), np.sin(yaw)
    return pts @ np.array([[c, s], [-s, c]])


@pytest.mark.parametrize("yaw", [0.4, 1.1])
def test_min_shrink_rect_and_key_vertex(yaw):
    pts = lshape(yaw)
    got = tfgr.min_shrink_rect(pts)
    want = jfgr.min_shrink_rect(pts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    box, angle, final = got
    assert abs(((angle - yaw) + np.pi / 4) % (np.pi / 2) - np.pi / 4) < 0.05
    kv = tfgr.find_key_vertex(pts, box)
    for g, w in zip(kv, jfgr.find_key_vertex(pts, box)):
        np.testing.assert_array_equal(g, w)
    i1, i2, p1, p2, n1, n2 = kv
    assert np.linalg.norm(p2 if n1 < n2 else p1) < 0.3
    for key in range(4):
        for g, w in zip(tfgr.delete_extremal(final, key, pts),
                        jfgr.delete_extremal(final, key, pts)):
            np.testing.assert_array_equal(g, w)


def test_region_grow_rejects_low_origin_ratio():
    a = np.random.RandomState(1).uniform(0, 1, (50, 3))
    pc = np.concatenate([a, a + np.array([5.0, 0, 0])])
    origin = np.zeros(100)
    origin[:50] = 1
    grown = tfgr.region_grow(pc, np.ones(100), origin, 0.5, 0.8)
    np.testing.assert_array_equal(
        grown, jfgr.region_grow(pc, np.ones(100), origin, 0.5, 0.8))
    assert grown[:50].sum() > 0 and grown[50:].sum() == 0
    grown2 = tfgr.region_grow(pc, np.ones(100), np.ones(100), 6.0, None)
    assert grown2.sum() == 100


@pytest.mark.parametrize("seed", range(12))
def test_region_grow_matches_reference(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(5, 300)
    k = rng.randint(1, 4)
    pc = rng.uniform(-3, 3, (k, 3))[rng.randint(k, size=n)] \
        + rng.normal(0, rng.uniform(0.05, 0.6), (n, 3))
    pc = pc.astype(np.float32 if seed % 2 else np.float64)
    search = (rng.uniform(size=n) < 0.8).astype(float)
    origin = (rng.uniform(size=n) < 0.5).astype(float)
    thr = (seed % 5 + 1) * 0.1
    ratio = None if seed % 4 == 0 else 0.8
    np.testing.assert_array_equal(
        tfgr.region_grow(pc, search, origin, thr, ratio),
        jfgr.region_grow(pc, search, origin, thr, ratio))


def test_calculate_ground_draws_alike():
    rng = np.random.RandomState(2)
    ground = np.stack([rng.uniform(-20, 20, 400), np.full(400, -1.8),
                       rng.uniform(0, 40, 400)], 1)
    obj = np.stack([rng.uniform(-1, 1, 100), rng.uniform(-1, 0.5, 100),
                    rng.uniform(9, 11, 100)], 1)
    pc = np.concatenate([ground, obj])
    got = tfgr.calculate_ground(pc, 0.15, np.random.RandomState(0))
    want = jfgr.calculate_ground(pc, 0.15, np.random.RandomState(0))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][:400].sum() < 40 and got[0][400:].sum() > 80


def fgr_scene(seed, boxes):
    l2i, _, _ = make_camera()
    rng = np.random.RandomState(seed)
    obj = [_box_surface_points(b, rng) for b in boxes]
    ground = np.stack([rng.uniform(2, 30, 800), rng.uniform(-12, 12, 800),
                       np.full(800, -1.6)], 1)
    pts = np.concatenate(obj + [ground]).astype(np.float32)
    dets = np.stack([project_box_2d(b.astype(np.float64), l2i)
                     for b in boxes])
    n = len(boxes)
    return pts, dets, np.arange(1, n + 1), np.full(n, 0.9), \
        np.zeros(n, np.int64), l2i[None]


CAR = np.array([11.0, -2.0, -0.6, 4.2, 1.9, 1.6, 1.2])
CAR2 = np.array([20.0, 5.0, -0.7, 4.5, 2.0, 1.5, 0.3])


@pytest.mark.parametrize("seed,boxes", [(3, [CAR]), (4, [CAR, CAR2])])
def test_fgr_matches_reference(seed, boxes):
    scene = fgr_scene(seed, boxes)
    got = tfgr.FGR(["car"] * 10, seed=0).propose(*scene)
    want = jfgr.FGR(["car"] * 10, seed=0).propose(*scene)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) >= 1
    np.testing.assert_allclose(got[0][0, :3], CAR[:3], atol=0.5)
    np.testing.assert_allclose(got[0][0, 3:6], CAR[3:6], atol=0.4)
    dyaw = abs(((got[0][0, 6] - CAR[6]) + np.pi / 2) % np.pi - np.pi / 2)
    assert dyaw < 0.18 and got[2][0] == 1
