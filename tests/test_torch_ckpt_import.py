"""The port's reference-checkpoint import (findnpropagate_torch/utils/
ckpt_import.py) — tests/test_ckpt_import.py for the port, run without its
`slow` mark: the committed fixtures read with torch.load, activation
parity of an imported BaseBEVBackbone and attention, the spconv tap
layout, rule coverage of the narrow TransFusion, and one reference-named
state dict imported by both packages, equal leaf by leaf.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from findnpropagate_torch.config import EDict
from findnpropagate_torch.datasets.synthetic import SyntheticDataset
from findnpropagate_torch.models import build_network
from findnpropagate_torch.models.backbones_2d.base_bev_backbone import (
    BaseBEVBackbone,
)
from findnpropagate_torch.models.model_utils.transformer import (
    MultiHeadAttention,
)
from findnpropagate_torch.utils.ckpt_import import (
    import_state_dict,
    load_reference_checkpoint,
    split_in_proj,
    t_spconv,
    transfusion_rules,
)
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from test_torch_transfusion import DATA, narrow_cfg

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_load_roundtrip():
    """The committed .pth (mixed dtypes, non-contiguous tensors) reads back
    exactly with torch.load(weights_only=True)."""
    out = torch.load(FIXTURES / "roundtrip.pth", weights_only=True)
    exp = np.load(FIXTURES / "roundtrip_expected.npz")
    assert out["epoch"] == 3 and out["it"] == 11
    for k in ("half", "bf16", "noncontig"):
        np.testing.assert_allclose(out[k].float().numpy(), exp[k])
    n = 0
    for k in exp.files:
        if k.startswith("model_state/"):
            np.testing.assert_allclose(
                out["model_state"][k.split("/", 1)[1]].float().numpy(),
                exp[k])
            n += 1
    assert n > 0


def test_bev_backbone_activation_parity(tmp_path):
    """A reference-shaped BaseBEVBackbone's torch activations (fixture)
    against the port's module with the imported weights, at eval."""
    cfg = {"LAYER_NUMS": [2, 2], "LAYER_STRIDES": [1, 2],
           "NUM_FILTERS": [16, 32], "UPSAMPLE_STRIDES": [1, 2],
           "NUM_UPSAMPLE_FILTERS": [16, 16],
           "USE_CONV_FOR_NO_STRIDE": True}
    exp = np.load(FIXTURES / "bev_expected.npz")
    holder = torch.nn.Module()
    holder.backbone_2d = BaseBEVBackbone(cfg, input_channels=24)
    report = load_reference_checkpoint(FIXTURES / "bev.pth", holder,
                                       {"BACKBONE_2D": cfg})
    assert not report["mismatched"], report["mismatched"]
    assert not report["unmatched_torch"], report["unmatched_torch"]
    loaded = {p for _, p in report["loaded"]}
    assert loaded == set(holder.state_dict())
    bb = holder.backbone_2d.eval()
    with torch.no_grad():
        got = bb({"spatial_features": torch.from_numpy(
            exp["x"]).permute(0, 3, 1, 2).contiguous()})[
                "spatial_features_2d"]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), exp["want"],
                               atol=2e-4)


def test_attention_import_parity():
    """torch nn.MultiheadAttention weights (fixture) into the port's
    MultiHeadAttention through the in_proj split."""
    fx = np.load(FIXTURES / "mha.npz")
    d = fx["in_proj_weight"].shape[1]
    attn = MultiHeadAttention(d, int(fx["num_heads"])).eval()
    w = torch.from_numpy(fx["in_proj_weight"])
    b = torch.from_numpy(fx["in_proj_bias"])
    with torch.no_grad():
        for which, lin in zip("qkv", (attn.query, attn.key, attn.value)):
            lin.weight.copy_(split_in_proj(which)(w))
            lin.bias.copy_(split_in_proj(which)(b))
        attn.out.weight.copy_(torch.from_numpy(fx["out_w"]))
        attn.out.bias.copy_(torch.from_numpy(fx["out_b"]))
        k = torch.from_numpy(fx["k"])
        got = attn(torch.from_numpy(fx["q"]), k, k)
    np.testing.assert_allclose(got.numpy(), fx["want"], atol=1e-5)


def test_spconv_layout_tap_correspondence():
    """Tap (dz, dy, dx) of a v2 weight lands at C-order index
    ((dz*ky)+dy)*kx+dx with (I, O) trailing; a v1 weight whose channels
    exceed 7 is read as v1."""
    o, i = 6, 4
    w_v2 = torch.arange(o * 27 * i, dtype=torch.float32).reshape(
        o, 3, 3, 3, i)
    got = t_spconv(w_v2)
    assert got.shape == (27, i, o)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                k = (dz * 3 + dy) * 3 + dx
                assert torch.equal(got[k], w_v2[:, dz, dy, dx, :].T)
    w_v1 = torch.randn(3, 3, 3, 16, 32)
    got1 = t_spconv(w_v1)
    assert got1.shape == (27, 16, 32)
    assert torch.equal(got1[13], w_v1[1, 1, 1])
    with pytest.raises(ValueError):
        t_spconv(torch.zeros(3, 3, 3))


@pytest.fixture(scope="module")
def narrow():
    cfg = narrow_cfg()
    ds = SyntheticDataset(EDict(DATA), cfg.CLASS_NAMES, training=False)

    def build():
        return build_network(copy.deepcopy(cfg.MODEL), num_class=10,
                             dataset=ds, device="cpu")
    return cfg, build


def test_transfusion_rule_coverage(narrow):
    """Every parameter and buffer of the narrow TransFusion is the target
    of a rule (nothing silently random after an import)."""
    cfg, build = narrow
    targets = {p for _, p, _ in transfusion_rules(cfg.MODEL)}
    missing = sorted(set(build().state_dict()) - targets)
    assert not missing, missing


# layers whose reference module is a kernel-1 Conv1d: (O, I, 1)
CONV1D = ("class_encoding", "prediction_head", "posembed")


def reference_state_dict(det, rules):
    """The port's state in the reference's names and layouts: the inverse
    of each rule (sparse kernels as spconv v2, the attention thirds
    concatenated into in_proj, kernel-1 Conv1d weights 3-D)."""
    state = det.state_dict()
    grouped = {}
    for tkey, pkey, tr in rules:
        if pkey in state:
            grouped.setdefault(tkey, []).append((pkey, tr))
    out = {}
    for tkey, parts in grouped.items():
        vals = [state[p] for p, _ in parts]
        name = parts[0][1].__name__
        if len(vals) == 3:                       # q, k, v -> in_proj
            out[tkey] = torch.cat(vals)
        elif name == "t_spconv":
            k, i, o = vals[0].shape
            kz, ky, kx = (3, 3, 3) if k == 27 else (3, 1, 1)
            out[tkey] = vals[0].reshape(kz, ky, kx, i, o).permute(
                4, 0, 1, 2, 3).contiguous()
        elif name == "t_linear" and any(c in tkey for c in CONV1D):
            out[tkey] = vals[0][..., None]
        else:
            out[tkey] = vals[0]
    return out


def test_both_packages_import_one_reference_state_dict(narrow):
    """A reference-named state dict of random values, imported by the port
    and by the JAX package (its variables then loaded into the port by
    from_jax_variables), gives the same module, leaf by leaf; and the port
    gets back exactly the values the state dict was made from."""
    from findnpropagate_tpu.utils import ckpt_import as jax_import

    cfg, build = narrow
    source = build()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in source.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen))
    rules = transfusion_rules(cfg.MODEL)
    ref = reference_state_dict(source, rules)

    det = build()
    report = import_state_dict(ref, det, rules)
    assert not report["mismatched"] and not report["unmatched_torch"]
    assert {p for _, p in report["loaded"]} == set(det.state_dict())
    for k, v in source.state_dict().items():
        assert torch.equal(det.state_dict()[k], v), k

    shapes = {c: to_jax_tree(source, w) for c, w in
              (("params", "param"), ("batch_stats", "batch_stats"))}
    jvars, jreport = jax_import.import_state_dict(
        {k: v.numpy() for k, v in ref.items()}, shapes,
        jax_import.transfusion_rules(cfg.MODEL))
    assert not jreport["mismatched"] and not jreport["unmatched_torch"]
    assert len(jreport["loaded"]) == len(
        [r for r in report["loaded"] if "num_batches" not in r[0]])
    via_jax = build()
    from_jax_variables(jax_import_np(jvars), via_jax)
    for k, v in det.state_dict().items():
        if "num_batches" not in k:
            np.testing.assert_array_equal(via_jax.state_dict()[k].numpy(),
                                          v.numpy(), err_msg=k)


def jax_import_np(tree):
    if hasattr(tree, "items"):
        return {k: jax_import_np(v) for k, v in tree.items()}
    return np.asarray(tree)
