"""The whole slice — TransFusion-LiDAR inference, points to detections — of
the PyTorch port against the JAX detector at narrow widths (backbone 16
channels, BEV filters 16/32, hidden 32, 2 heads, 20 proposals) on a
cropped lidar_ring scene at batch 2, with the same random weights.

The JAX side runs its exact XLA windowed sparse convs (SUBM_IMPL: xla);
the posgather path equals them whenever the overflow counter is 0, which
is asserted, and tests/test_torch_backbone.py holds the port against the
posgather kernels themselves. JAX matmuls run at highest precision.
Tolerance: rtol/atol 1e-5 on head outputs and boxes — both f32, different
summation orders through ~30 layers; labels, query classes and counts
exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network as torch_build
from findnpropagate_torch.utils.weights import from_jax_variables, init_random_
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.config import cfg_from_yaml_file
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build

B = 2
DATA = {
    "DATASET": "SyntheticDataset",
    "POINT_CLOUD_RANGE": [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0],
    "SYNTHETIC": {"NUM_SCENES": B, "NUM_OBJECTS": 40,
                  "NUM_RAW_POINTS": 200000, "PATTERN": "lidar_ring"},
    "CAPACITIES": {"MAX_POINTS": 40000, "MAX_GT": 256, "MAX_VOXELS": 2048,
                   "MAX_POINTS_PER_VOXEL": 10},
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"]},
    "DATA_PROCESSOR": [
        {"NAME": "mask_points_and_boxes_outside_range",
         "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "shuffle_points",
         "SHUFFLE_ENABLED": {"train": False, "test": False}},
        {"NAME": "transform_points_to_voxels",
         "VOXEL_SIZE": [0.2, 0.2, 0.2]}],
}
HEAD_KEYS = ("center", "height", "dim", "rot", "vel", "heatmap",
             "query_heatmap_score")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_cfg():
    cfg = cfg_from_yaml_file("tools/cfgs/nuscenes_models/transfusion_lidar.yaml")
    m = cfg.MODEL
    m.BACKBONE_3D.update({
        "MAX_VOXELS": 2048, "LEVEL_CAPACITIES": [2048, 2048, 2048, 1024, 1024],
        "WINDOWED_BLOCK": 512, "CHANNELS": [16, 16, 16, 16, 16],
        "OUT_CHANNELS": 16, "DENSE_DTYPE": "f32"})
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update({"LAYER_NUMS": [1, 1], "NUM_FILTERS": [16, 32],
                          "NUM_UPSAMPLE_FILTERS": [16, 16]})
    m.DENSE_HEAD.update({"HIDDEN_CHANNEL": 32, "NUM_HEADS": 2,
                         "FFN_CHANNEL": 64, "NUM_PROPOSALS": 20})
    return cfg


@pytest.fixture(scope="module")
def models():
    cfg = narrow_cfg()
    jcfg = copy.deepcopy(cfg.MODEL)
    jcfg.BACKBONE_3D["SUBM_IMPL"] = "xla"
    ds, loader, _ = build_dataloader(JEDict(DATA), cfg.CLASS_NAMES,
                                     batch_size=B, training=False,
                                     prefetch=0)
    jdet = jax_build(jcfg, num_class=10, dataset=ds)
    batch = next(iter(loader))
    batch.pop("frame_id")
    batch.pop("batch_size")
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, batch))

    tds = SyntheticDataset(EDict(DATA), cfg.CLASS_NAMES, training=False)
    tbatch = tds.batch(range(B))
    np.testing.assert_array_equal(tbatch["points"], batch["points"])
    np.testing.assert_array_equal(tbatch["points_mask"],
                                  batch["points_mask"])
    tdet = torch_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=tds,
                       device="cpu")
    return jdet, variables, batch, tdet


def run_both(models, variables):
    jdet, _, batch, tdet = models
    with jax.default_matmul_precision("highest"):
        out = jdet.apply(variables, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, train=False)
        dets = jdet.post_process(out)
    from_jax_variables(variables, tdet)
    tout = tdet({k: torch.from_numpy(v) for k, v in batch.items()})
    return out, dets, tout, tdet.post_process(tout)


def check_heads_and_detections(out, dets, tout, tdets):
    rj, rt = out["transfusion_preds"], tout["transfusion_preds"]
    np.testing.assert_array_equal(rt["query_labels"].numpy(),
                                  np.asarray(rj["query_labels"]))
    for k in HEAD_KEYS:
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        rt["dense_heatmap"].permute(0, 2, 3, 1).numpy(),
        np.asarray(rj["dense_heatmap"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tdets.count.numpy(), np.asarray(dets.count))
    np.testing.assert_array_equal(tdets.labels.numpy(),
                                  np.asarray(dets.labels))
    np.testing.assert_allclose(tdets.boxes.numpy(), np.asarray(dets.boxes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tdets.scores.numpy(), np.asarray(dets.scores),
                               rtol=1e-5, atol=1e-5)


def test_transfusion_matches_jax(models):
    out, dets, tout, tdets = run_both(models, models[1])
    assert int(out["sparse_window_overflow"]) == 0
    assert int(tout["sparse_window_overflow"]) == 0
    np.testing.assert_array_equal(tout["sparse_active_counts"].numpy(),
                                  np.asarray(out["sparse_active_counts"]))
    np.testing.assert_allclose(
        tout["encoded_spconv_tensor"].permute(0, 2, 3, 4, 1).numpy(),
        np.asarray(out["encoded_spconv_tensor"]), rtol=1e-5, atol=1e-6)
    check_heads_and_detections(out, dets, tout, tdets)
    assert int(tdets.count.min()) > 0


def test_topk_ties_match_jax(models):
    """A flat heatmap (zero hm_out kernel) makes every local-max score
    equal, so both top-k's — the query selection and get_bboxes — are
    decided by tie order alone: the lower index first, as jax.lax.top_k."""
    variables = copy.deepcopy(models[1])
    hm = variables["params"]["dense_head"]["hm_out"]
    hm["kernel"] = np.zeros_like(hm["kernel"])
    hm["bias"] = np.full_like(hm["bias"], 0.5)
    out, dets, tout, tdets = run_both(models, variables)
    scores = np.asarray(out["transfusion_preds"]["query_heatmap_score"])
    assert np.unique(scores[scores > 0]).size == 1    # all tied
    check_heads_and_detections(out, dets, tout, tdets)


def test_init_random_matches_bench(models):
    """init_random_ gives the port exactly bench.py's random weights."""
    _, variables, _, tdet = models
    ref = copy.deepcopy(tdet)
    from_jax_variables(variables, ref)
    init_random_(tdet, seed=0)
    for (k, a), (_, b) in zip(tdet.state_dict().items(),
                              ref.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
