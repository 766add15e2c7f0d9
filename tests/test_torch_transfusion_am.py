"""TransFusionHeadAM (the paper's anchor-matching head) of the PyTorch port
against the JAX package: `hard_bin_vectors` on the three anchors of
tests/test_transfusion_am.py and on the default nuScenes table, and the
head on the narrow TransFusion-LiDAR of tests/test_torch_transfusion_train
(its cropped lidar_ring scenes at batch 2, dropout 0 on both sides, the
main path's posgather backbone; on CPU tensors the kernels' plain
versions) with the default anchor table as its class space: the forward's
outputs (the matched dense heatmap, the queries' classes, the per-query
regression and matched logits) in eval mode, and the training loss with
its tb entries and the backbone's overflow, and the detections decoded
from the same outputs.

Tolerances: anchor vectors, query classes and indices exact; head outputs
rtol / atol 1e-4 in float32 (the backbone's 1e-4 carried through the BEV
backbone and one decoder layer); losses rtol 1e-4.
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
from findnpropagate_torch.models.dense_heads import transfusion_head_am as TAM
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.config import EDict as JEDict
from findnpropagate_tpu.datasets import build_dataloader
from findnpropagate_tpu.models import build_network as jax_build
from findnpropagate_tpu.models.dense_heads import transfusion_head_am as JAM
from tests.test_torch_transfusion_train import flat, train_cfg, train_data
from tests.test_transfusion_am import ANCHORS

B = 2
FWD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("anchors,bins", [(ANCHORS, 8),
                                          (JAM.DEFAULT_ANCHORS, 20)])
def test_hard_bin_vectors_match_jax(anchors, bins):
    log_a = np.log(np.asarray(anchors, np.float32))
    np.testing.assert_array_equal(TAM.hard_bin_vectors(log_a, bins),
                                  JAM.hard_bin_vectors(log_a, bins))
    assert TAM.DEFAULT_ANCHORS == JAM.DEFAULT_ANCHORS


@pytest.fixture(scope="module")
def am():
    cfg = train_cfg()
    cfg.MODEL.DENSE_HEAD.NAME = "TransFusionHeadAM"
    cfg.MODEL.DENSE_HEAD.ANCHOR_SIZE_BINS = 8
    jcfg = copy.deepcopy(cfg.MODEL)
    jcfg.BACKBONE_3D["SUBM_IMPL"] = "xla"
    ds, _, _ = build_dataloader(JEDict(train_data()), cfg.CLASS_NAMES,
                                batch_size=B, training=True, prefetch=0)
    batch = ds.collate_batch([ds[i] for i in range(B)])
    batch.pop("frame_id")
    batch.pop("batch_size")
    jdet = jax_build(jcfg, num_class=10, dataset=ds)
    variables = jax.tree.map(np.asarray, bench._random_variables(jdet, batch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, b: jdet.apply(v, b, train=False)[
            "transfusion_preds"])(variables, jb)
        loss, (tb, _) = jax.jit(lambda v, b: jdet.loss(
            v, b, rng=jax.random.PRNGKey(0)))(variables, jb)
    tds = SyntheticDataset(EDict(train_data()), cfg.CLASS_NAMES,
                           training=True)
    tdet = torch_build(copy.deepcopy(cfg.MODEL), num_class=10, dataset=tds,
                       device="cpu")
    from_jax_variables(variables, tdet)
    return (variables, batch, jax.tree.map(np.asarray, out), float(loss),
            {k: float(v) for k, v in tb.items()}, tdet, jdet)


def test_am_head_tree_and_class_space(am):
    variables, _, _, _, _, tdet, _ = am
    head = tdet.dense_head
    assert head.num_classes == len(JAM.DEFAULT_ANCHORS)
    assert head.text_dim == 24 and not hasattr(head, "class_encoding")
    got = flat(to_jax_tree(tdet))
    assert set(got) == set(flat(variables["params"]))
    for leaf in head.FLAX_LEAVES:
        np.testing.assert_array_equal(
            got[("dense_head", leaf)],
            variables["params"]["dense_head"][leaf])


def test_am_forward_matches_jax(am):
    _, batch, out, _, _, tdet, _ = am
    with torch.no_grad():
        res = tdet.eval()({k: torch.from_numpy(v) for k, v in batch.items()}
                          )["transfusion_preds"]
    np.testing.assert_array_equal(res["query_labels"].numpy(),
                                  out["query_labels"])
    assert len(np.unique(out["query_labels"])) > 1
    np.testing.assert_allclose(res["dense_heatmap"].permute(
        0, 2, 3, 1).numpy(), out["dense_heatmap"], **FWD)
    for k in ("heatmap", "center", "height", "dim", "rot", "vel",
              "query_heatmap_score"):
        np.testing.assert_allclose(res[k].numpy(), out[k], err_msg=k, **FWD)


def test_am_detections_match_jax(am):
    """post_process of the same head outputs on both sides: labels in the
    anchor-class space exact, boxes and scores 1e-5."""
    _, _, out, _, _, tdet, jdet = am
    jd = jax.jit(jdet.post_process)({"transfusion_preds": out})
    td = tdet.post_process({"transfusion_preds": {
        k: torch.from_numpy(v) for k, v in out.items()}})
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))
    assert int(td.labels.max()) <= len(JAM.DEFAULT_ANCHORS)
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores),
                               rtol=1e-5, atol=1e-5)


def test_am_loss_matches_jax(am):
    _, batch, _, jloss, jtb, tdet, _ = am
    det = copy.deepcopy(tdet).train()
    loss, tb = det.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.Generator().manual_seed(0))
    assert int(tb["sparse_window_overflow"]) == 0
    assert set(tb) == set(jtb)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    for k, v in jtb.items():
        np.testing.assert_allclose(float(tb[k]), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    loss.backward()
    grads = flat(to_jax_tree(det, "grad"))
    assert np.abs(grads[("dense_head", "anchor_query_encoding",
                         "kernel")]).max() > 0
