"""The dense levels' epilogue (ops/dense_epilogue.py) on the CPU.

Its plain version against the PyTorch chain it replaced, element for
element (`torch.equal`): the masked eval BatchNorm and ReLU of a dense conv
and the residual of a block's second conv, as `_masked_bn_relu`,
`MaskedBatchNorm.forward` and `_blocks` computed them, in bf16 and float32,
with and without ReLU and identity, over 3D and 2D maps, with masks all
true, all false and random. The wrapper's CUDA branch against a fake
library (arguments, the vector path's choice, what it refuses). A
VoxelResBackBone8x eval forward at DENSE_FROM_LEVEL 3 against the same
forward with that chain in the epilogue's place, and a forward with
autograd on the PyTorch path with its gradients. The kernel itself runs on
the card only (chip_smoke.py, `dense_epilogue_phase`)."""

import numpy as np
import pytest
import torch

from findnpropagate_torch.models.backbones_3d import spconv_backbone as SB
from findnpropagate_torch.models.backbones_3d.spconv_backbone import (
    VoxelResBackBone8x,
)
from findnpropagate_torch.models.blocks import MaskedBatchNorm
from findnpropagate_torch.ops import dense_epilogue as DE


def chain_bn(x, valid, k, s):
    """The eval branch of MaskedBatchNorm.forward as it was, with
    `inplace=True`."""
    m = valid.unsqueeze(1)
    shape = [1, -1] + [1] * (x.ndim - 2)
    if x.dtype == torch.float32:
        return x.mul_(k.view(shape)).add_(s.view(shape)).masked_fill_(~m, 0)
    y = x.float() * k.view(shape) + s.view(shape)
    return torch.where(m, y, torch.zeros_like(y)).to(x.dtype)


def chain(y, mask, k, s, relu, identity=None):
    """The dense tail as it was without autograd: `_masked_bn_relu`, and
    after a block's second conv (relu off there) `_blocks`' residual."""
    y = chain_bn(y.masked_fill_(~mask[:, None], 0), mask, k, s)
    if identity is None:
        return y.relu_() if relu else y
    y = y.add_(identity)
    if relu:
        y = y.relu_()
    return y.masked_fill_(~mask[:, None], 0)


def inputs(dtype, spatial, mask_kind, seed=0, b=2, c=6):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn((b, c, *spatial), generator=g) * 3).to(dtype)
    if mask_kind == "all":
        m = torch.ones((b, *spatial), dtype=torch.bool)
    elif mask_kind == "none":
        m = torch.zeros((b, *spatial), dtype=torch.bool)
    else:
        m = torch.rand((b, *spatial), generator=g) < 0.6
    k = torch.rand(c, generator=g) * 2 + 0.1
    s = torch.randn(c, generator=g)
    ident = (torch.randn((b, c, *spatial), generator=g) * 2).to(dtype)
    return y, m, k, s, ident


@pytest.mark.parametrize("mask_kind", ["all", "none", "random"])
@pytest.mark.parametrize("spatial", [(3, 5, 8), (5, 7)])
@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_equals_the_torch_chain(dtype, relu, identity, spatial,
                                      mask_kind):
    y, m, k, s, ident = inputs(dtype, spatial, mask_kind)
    ident = ident if identity else None
    want = chain(y.clone(), m, k, s, relu, ident)
    y_in = y.clone()
    got = DE.dense_epilogue_plain(y_in, m, k, s, relu, ident)
    assert got.data_ptr() == y_in.data_ptr()        # in place
    assert got.dtype == dtype and torch.equal(got, want)
    if mask_kind == "none":
        assert not got.any()


def test_cpu_takes_the_plain_version():
    DE.reset_launches()
    y, m, k, s, ident = inputs(torch.bfloat16, (3, 5, 8), "random")
    want = chain(y.clone(), m, k, s, True, ident)
    got = DE.dense_epilogue(y, m, k, s, True, ident)
    assert torch.equal(got, want)
    assert DE.LAUNCHES["dense_epilogue"] == 0


class _FakeLib:
    """Records the C entry's arguments; returns 0 (no error)."""

    def __init__(self):
        self.calls = []

        def entry(*args):
            self.calls.append(args)
            return 0
        entry.argtypes = None
        self.fp_dense_epilogue = entry


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(DE, "_check_device", lambda *t: True)
    monkeypatch.setattr(DE, "_lib", lambda: lib)
    monkeypatch.setattr(DE, "_stream", lambda: 0)
    DE.reset_launches()
    return lib


@pytest.mark.parametrize("dtype,spatial,vector", [
    (torch.bfloat16, (5, 16, 18), 1),        # 1440 % 8 == 0
    (torch.bfloat16, (2, 16, 18), 1),
    (torch.bfloat16, (5, 18, 18), 0),        # 1620: one element a thread
    (torch.bfloat16, (3, 5, 7), 0),
    (torch.float32, (5, 18, 18), 1),         # 1620 % 4 == 0
    (torch.float32, (3, 5, 7), 0),
    (torch.float32, (4, 6), 1),              # a 2D map, 24 % 4 == 0
])
@pytest.mark.parametrize("identity", [False, True])
def test_cuda_branch_arguments(fake, dtype, spatial, vector, identity):
    y, m, k, s, ident = inputs(dtype, spatial, "random", b=3, c=4)
    ident = ident if identity else None
    out = DE.dense_epilogue(y, m, k, s, False, ident)
    assert out is y
    (args,) = fake.calls
    (yp, ip, mp, kp, sp, rows, n, c, dt, vec, relu, stream) = args
    assert (yp, mp) == (y.data_ptr(), m.data_ptr())
    assert ip == (None if ident is None else ident.data_ptr())
    assert (rows, n, c) == (12, int(np.prod(spatial)), 4)
    assert (dt, vec, relu, stream) == (DE.DTYPES[dtype], vector, 0, 0)
    assert DE.LAUNCHES["dense_epilogue"] == 1


def test_cuda_branch_unaligned_map_is_scalar(fake):
    buf = torch.zeros(2 * 4 * 5 * 8 * 8 + 1, dtype=torch.bfloat16)
    y = buf[1:].view(2, 4, 5, 8, 8)              # 2 bytes off 16
    m = torch.ones(2, 5, 8, 8, dtype=torch.bool)
    DE.dense_epilogue(y, m, torch.ones(4), torch.zeros(4), True)
    assert fake.calls[0][9] == 0


def test_cuda_branch_refuses(fake):
    y, m, k, s, ident = inputs(torch.bfloat16, (3, 4, 8), "random", c=4)
    cl = y.to(memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError, match="channels_last_3d"):
        DE.dense_epilogue(cl, m, k, s, True)
    with pytest.raises(ValueError, match="mask"):
        DE.dense_epilogue(y, m.to(torch.uint8), k, s, True)
    with pytest.raises(ValueError, match="identity"):
        DE.dense_epilogue(y, m, k, s, True, ident.float())
    with pytest.raises(ValueError, match="scale"):
        DE.dense_epilogue(y, m, k[:3], s[:3], True)
    with pytest.raises(ValueError, match="dtype"):
        DE.dense_epilogue(y.half(), m, k, s, True)
    assert fake.calls == [] and DE.LAUNCHES["dense_epilogue"] == 0


# ---- the backbone -------------------------------------------------------

GRID = (32, 32, 40)      # nx, ny, nz: dense levels (5, 4, 4) and (2, 4, 4)
CFG = {"MAX_VOXELS": 1024, "LEVEL_CAPACITIES": [1024] * 5,
       "DENSE_FROM_LEVEL": 3, "SUBM_MODE": "windowed",
       "SUBM_IMPL": "posgather", "WINDOWED_BLOCK": 512,
       "WINDOWED_WINDOW": 512, "CHANNELS": [16, 16, 16, 16, 16],
       "OUT_CHANNELS": 16}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: tier-1 runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def backbone(dense_dtype, seed=0):
    torch.manual_seed(seed)
    bb = VoxelResBackBone8x(dict(CFG, DENSE_DTYPE=dense_dtype), 4, GRID)
    with torch.no_grad():
        for mod in bb.modules():
            if isinstance(mod, SB.SparseConvParam):
                k, cin, _ = mod.kernel.shape
                mod.kernel.normal_(0, (2.0 / (k * cin)) ** 0.5)
                if mod.bias is not None:
                    mod.bias.normal_(0, 0.1)
            elif isinstance(mod, MaskedBatchNorm):
                mod.scale.uniform_(0.5, 1.5)
                mod.bias.normal_(0, 0.1)
                mod.mean.normal_(0, 0.1)
                mod.var.uniform_(0.5, 2.0)
    return bb.eval()


def scene(b=2, n=300, v_cap=400, seed=3):
    rng = np.random.RandomState(seed)
    nx, ny, nz = GRID
    coords = np.full((b, v_cap, 3), -1, np.int32)
    valid = np.zeros((b, v_cap), bool)
    for i in range(b):
        lin = rng.choice(nx * ny * nz, n, replace=False)
        z, rem = lin // (ny * nx), lin % (ny * nx)
        coords[i, :n] = np.stack([z, rem // nx, rem % nx], -1)
        valid[i, :n] = True
    feats = rng.randn(b, v_cap, 4).astype(np.float32) * valid[..., None]
    return {"voxel_features": torch.from_numpy(feats),
            "voxel_coords": torch.from_numpy(coords),
            "voxel_mask": torch.from_numpy(valid)}


def chain_tail(y, mask, bnmod, relu, identity=None):
    k, s = bnmod.affine()
    return chain(y, mask, k, s, relu, identity)


def outputs(out):
    """The encoded map and the features and masks of levels 3 and 4."""
    got = {"encoded": out["encoded_spconv_tensor"]}
    for name in ("x_conv3", "x_conv4"):
        kind, a, m = out["multi_scale_3d_features"][name]
        got[name], got[name + ".mask"] = (a, m) if kind == "dense" \
            else (a[3], a[2])
    return got


@pytest.mark.parametrize("dense_dtype", ["bf16", "f32"])
def test_backbone_eval_equals_the_torch_chain(dense_dtype, monkeypatch):
    bb = backbone(dense_dtype)
    calls = []
    wrapper = DE.dense_epilogue

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return wrapper(*a, **kw)
    monkeypatch.setattr(SB, "dense_epilogue", counted)
    DE.reset_launches()
    with torch.no_grad():
        got = outputs(bb(scene()))
    # four submanifold convs of stage 4 and conv_out
    want_dtype = torch.bfloat16 if dense_dtype == "bf16" else torch.float32
    assert calls == [want_dtype] * 5
    assert DE.LAUNCHES["dense_epilogue"] == 0
    monkeypatch.setattr(SB, "_dense_bn_act", chain_tail)
    with torch.no_grad():
        want = outputs(bb(scene()))
    assert got["x_conv4"][0].dtype == want_dtype
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_backbone_with_autograd_runs_the_torch_path(monkeypatch):
    bb = backbone("bf16")
    with torch.no_grad():
        want = outputs(bb(scene()))

    def refuse(*a, **kw):
        raise AssertionError("the epilogue ran with autograd on")
    monkeypatch.setattr(SB, "dense_epilogue", refuse)
    out = bb(scene())
    got = outputs(out)
    for key in want:
        assert torch.equal(got[key].detach(), want[key]), key
    out["encoded_spconv_tensor"].square().sum().backward()
    for mod in (bb.blocks4_res0_conv1, bb.blocks4_res1_conv2, bb.w_out,
                bb.blocks4_res1_bn2):
        for p in mod.parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all()
            assert p.grad.abs().sum() > 0
