"""Weights across the two packages.

`from_jax_variables(variables, model)` loads a flax variable tree of the
JAX package — ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays — into the port's modules. The port names its submodules
after the flax tree, so the flax path of a leaf is the torch module path;
what differs is the layout, converted here:

  * sparse conv kernels (K, Cin, Cout) and MaskedBatchNorm: as they are;
  * Conv2d: flax HWIO -> OIHW; Conv3d: flax (k1, k2, k3, I, O) -> (O, I,
    k1, k2, k3) (PartA2FCHead's pooled grids, channels-first here);
  * ConvTranspose2d: flax (kh, kw, I, O), spatially flipped against
    torch's (I, O, kh, kw) (the inverse of utils/ckpt_import.t_deconv2d);
  * Dense -> Linear: kernel (in, out) -> weight (out, in);
  * MultiHeadDotProductAttention: query/key/value kernels (D, H, Dh) and
    biases (H, Dh) -> Linear (H*Dh, D); out kernel (H, Dh, D) -> (D, H*Dh);
  * BatchNorm: scale/bias/mean/var -> weight/bias/running_mean/running_var;
    LayerNorm: scale/bias -> weight/bias.

The same walk covers any module built from these layers under the flax
names, such as models/frustum_pointnets.py::PointNetInstanceSeg (its
``enc0_fc0`` Linear, ``enc0_bn0`` MaskedBatchNorm, ... ``seg_out``): a
flax variables tree of the JAX PointNetInstanceSeg, params and batch
statistics, loads into it as it stands; so do CenterHead's
(``shared_conv``, ``shared_bn``, ``group{i}``) and CenterHeadCLIP's,
whose flax auto-names (``Conv_0``, ``BatchNorm_0``, ``clip_head``) the
port's modules carry (its class text features are a buffer outside the
state dict and no leaf of either tree); PillarVFE's auto-named
``PFNLayer_{i}/Dense_0`` and ``MaskedBatchNorm_0``, the dynamic VFEs'
``pfn{i}_dense`` / ``pfn{i}_bn``, AnchorHeadSingle's ``conv_cls`` /
``conv_box`` / ``conv_dir`` and AnchorHeadMulti's ``shared_conv``,
``shared_bn``, ``h{i}_mid{j}``, ``h{i}_mid{j}_bn`` and ``h{i}_cls`` /
``_box`` / ``_dir`` (the anchors are non-persistent buffers, no leaf);
the VoxelNeXt / PillarNet backbones' ``blocks{s}_...``, ``w_out``,
``w_shared`` and PillarNet's dense ``conv5_down`` / ``conv5_res_{i}_{j}``,
BaseBEVBackboneV1's ``block{i}_conv{k}`` / ``deblock{i}``, VoxelNeXtHead's
``group{g}`` / ``{name}_conv{i}`` / ``{name}_bn{i}`` / ``{name}_out``, and
TransFusionHeadAM's, whose four scalar parameters are leaves of the head
itself (named by its FLAX_LEAVES; its anchor vectors are buffers); and the
two-stage modules' Linear + MaskedBatchNorm stacks: the VSA's ``sa_raw`` /
``sa_x_conv{i}`` set abstractions (``g{i}_fc{j}``, ``g{i}_bn{j}``),
``vp_x_conv{i}`` VectorPools (``mix``, ``mix_bn``) and
``vsa_point_feature_fusion`` / ``fusion_bn``, PointHeadSimple's
``cls_fc{i}`` / ``cls_bn{i}`` / ``cls_out``, and the ROI heads'
``roi_grid_pool`` / ``pool_x_conv{i}``, ``{shared,cls,reg,iou}_fc{i}`` /
``_bn{i}`` and ``cls_out`` / ``reg_out`` / ``iou_out``; and Part-A2's and
PointRCNN's: UNetV2's ``w_input``, ``enc{L}_{i}_0`` / ``_1``,
``down{L}_0`` / ``_1``, ``w_out`` and its decoder ``dec_t{L}_conv{j}``,
``dec_m{L}_conv``, ``dec_inv{L}_conv``, ``dec_conv5`` (sparse kernels)
with their BNs, PointNet2MSG's ``sa{k}/radius{r}/mlp{i}`` and
``fp{k}/fp/mlp{i}`` (+ ``_bn``), the point heads' ``{cls,part,reg}_fc{i}``
/ ``_bn{i}`` / ``_out``, PartA2FCHead's ``conv_part`` / ``conv_rpn``
(``conv{i}`` Conv3d, ``conv{i}_bn``) and PointRCNNHead's ``xyz_up``,
``merge_down``, ``sa{k}/mlp`` and ``{cls,reg}_fc`` (``fc{i}``,
``bn{i}``).

`to_jax_tree(model, what)` is the inverse map: the port's parameters,
their gradients or its BN statistics as a nested dict of numpy arrays under
the flax names and in the flax layouts, so the two packages compare leaf by
leaf.

`init_random_(model, seed)` gives the port the values that
bench.py:_random_variables gives the JAX model: every leaf of the flax
tree, in the tree's flattening order (sorted keys), drawn from
``RandomState(seed).standard_normal(shape) * 0.05`` in float32, then BN
means set to 0 and variances to 1.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.backbones_3d.spconv_backbone import SparseConvParam
from ..models.blocks import MaskedBatchNorm
from ..models.model_utils.transformer import MultiHeadAttention


def _leaves(model):
    """[(collection, flax path tuple, flax shape, to_torch, tensor,
    to_flax)]: every flax leaf of the model with its converters onto a
    torch tensor and back (numpy arrays both ways)."""
    out = []

    def add(coll, path, shape, fn, tensor, inv=None):
        out.append((coll, tuple(path), tuple(shape), fn, tensor,
                    inv or fn))

    same = lambda a: a  # noqa: E731
    mha_children = set()
    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        for leaf in getattr(mod, "FLAX_LEAVES", ()):
            # a module's own parameters that are flax leaves of its scope
            # (TransFusionHeadAM's match scales and biases)
            t = getattr(mod, leaf)
            add("params", path + [leaf], t.shape, same, t)
        if isinstance(mod, MultiHeadAttention):
            h, dh = mod.num_heads, mod.head_dim
            for child in ("query", "key", "value"):
                lin = getattr(mod, child)
                d = lin.in_features
                add("params", path + [child, "kernel"], (d, h, dh),
                    lambda a, d=d: a.reshape(d, -1).T, lin.weight,
                    lambda a, d=d, h=h, dh=dh: a.T.reshape(d, h, dh))
                add("params", path + [child, "bias"], (h, dh),
                    lambda a: a.reshape(-1), lin.bias,
                    lambda a, h=h, dh=dh: a.reshape(h, dh))
                mha_children.add(lin)
            d_out = mod.out.out_features
            add("params", path + ["out", "kernel"], (h, dh, d_out),
                lambda a, d_out=d_out: a.reshape(-1, d_out).T,
                mod.out.weight,
                lambda a, h=h, dh=dh, d_out=d_out: a.T.reshape(h, dh, d_out))
            add("params", path + ["out", "bias"], (d_out,), same,
                mod.out.bias)
            mha_children.add(mod.out)
        elif isinstance(mod, SparseConvParam):
            add("params", path + ["kernel"], mod.kernel.shape, same,
                mod.kernel)
            if mod.bias is not None:
                add("params", path + ["bias"], mod.bias.shape, same,
                    mod.bias)
        elif isinstance(mod, MaskedBatchNorm):
            for leaf, coll in (("scale", "params"), ("bias", "params"),
                               ("mean", "batch_stats"),
                               ("var", "batch_stats")):
                t = getattr(mod, leaf)
                add(coll, path + [leaf], t.shape, same, t)
        elif isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            add("params", path + ["kernel"], (kh, kw, i, o),
                lambda a: a.transpose(3, 2, 0, 1), mod.weight,
                lambda a: a.transpose(2, 3, 1, 0))
            if mod.bias is not None:
                add("params", path + ["bias"], (o,), same, mod.bias)
        elif isinstance(mod, nn.Conv3d):
            o, i, k1, k2, k3 = mod.weight.shape
            add("params", path + ["kernel"], (k1, k2, k3, i, o),
                lambda a: a.transpose(4, 3, 0, 1, 2), mod.weight,
                lambda a: a.transpose(2, 3, 4, 1, 0))
            if mod.bias is not None:
                add("params", path + ["bias"], (o,), same, mod.bias)
        elif isinstance(mod, nn.ConvTranspose2d):
            i, o, kh, kw = mod.weight.shape
            add("params", path + ["kernel"], (kh, kw, i, o),
                lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1), mod.weight,
                lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1])
        elif isinstance(mod, nn.Linear) and mod not in mha_children:
            o, i = mod.weight.shape
            add("params", path + ["kernel"], (i, o), lambda a: a.T,
                mod.weight)
            if mod.bias is not None:
                add("params", path + ["bias"], (o,), same, mod.bias)
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            add("params", path + ["scale"], mod.weight.shape, same,
                mod.weight)
            add("params", path + ["bias"], mod.bias.shape, same, mod.bias)
            add("batch_stats", path + ["mean"], mod.running_mean.shape,
                same, mod.running_mean)
            add("batch_stats", path + ["var"], mod.running_var.shape, same,
                mod.running_var)
        elif isinstance(mod, nn.LayerNorm):
            add("params", path + ["scale"], mod.weight.shape, same,
                mod.weight)
            add("params", path + ["bias"], mod.bias.shape, same, mod.bias)
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield prefix, tree


@torch.no_grad()
def from_jax_variables(variables, model):
    """Copy a flax variable tree (nested dicts of arrays) into `model`.
    Raises if a leaf is missing on either side or has the wrong shape."""
    given = {}
    for coll in ("params", "batch_stats"):
        for path, val in _flat(variables.get(coll, {})):
            given[(coll, path)] = np.asarray(val)
    used = set()
    for coll, path, shape, fn, tensor, _ in _leaves(model):
        key = (coll, path)
        if key not in given:
            raise KeyError(f"flax leaf {coll}/{'/'.join(path)} missing")
        val = given[key]
        if tuple(val.shape) != shape:
            raise ValueError(f"{coll}/{'/'.join(path)}: flax shape "
                             f"{val.shape}, port expects {shape}")
        tensor.copy_(torch.from_numpy(
            np.array(fn(val.astype(np.float32)), order="C", copy=True)))
        used.add(key)
    extra = sorted(set(given) - used)
    if extra:
        raise KeyError(f"flax leaves with no place in the port: {extra[:5]}")
    return model


def to_jax_tree(model, what: str = "param"):
    """The port's state under the flax names: ``what`` is "param" (the
    ``params`` collection), "grad" (the parameters' .grad, zeros where a
    parameter has none) or "batch_stats" (BN means and variances). Nested
    dict of float32 numpy arrays in the flax layouts."""
    if what not in ("param", "grad", "batch_stats"):
        raise ValueError(f"what={what!r}")
    coll_want = "batch_stats" if what == "batch_stats" else "params"
    tree: dict = {}
    for coll, path, shape, _, tensor, inv in _leaves(model):
        if coll != coll_want:
            continue
        t = tensor
        if what == "grad":
            t = tensor.grad if tensor.grad is not None \
                else torch.zeros_like(tensor)
        val = np.ascontiguousarray(inv(t.detach().cpu().float().numpy()))
        assert val.shape == shape, (path, val.shape, shape)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return tree


def init_random_(model, seed: int = 0):
    """bench.py:_random_variables for the port: N(0, 0.05^2) float32 leaves
    in flax flattening order, BN mean 0 and variance 1."""
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for coll, path, shape, _, _, _ in sorted(_leaves(model),
                                          key=lambda e: (e[0], e[1])):
        val = rng.standard_normal(shape).astype(np.float32) * 0.05
        if coll == "batch_stats":
            val = (np.zeros if path[-1] == "mean" else np.ones)(
                shape, np.float32)
        node = tree.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return from_jax_variables(tree, model)
