"""Reference-checkpoint import — port of
findnpropagate_tpu/utils/ckpt_import.py: OpenPCDet / reference state dicts
(the reference load path: pcdet/models/detectors/detector3d_template.py
:401-460, with the spconv v1 / v2 weight-shape adaptation at :408-419)
into the port's TransFusion-LiDAR, so the published checkpoints can drive
evaluation.

The rules are the port's own copy of the reference's, aimed at the port's
parameter names (the flax tree's paths, utils/weights.py) and at its
layouts, which are PyTorch's own:
  * spconv v2 (O, kz, ky, kx, I) and v1 (kz, ky, kx, I, O) -> the sparse
    kernels' (K = kz*ky*kx in C order, I, O) (SparseConvParam), with the
    reference's v1 / v2 heuristic;
  * Conv2d, ConvTranspose2d and Linear as they are; a kernel-1 Conv1d
    (O, I, 1) -> Linear (O, I);
  * nn.MultiheadAttention's in_proj (3D, D) -> the query / key / value
    Linears of model_utils/transformer.py::MultiHeadAttention, out_proj ->
    its ``out``;
  * BatchNorm weight / bias / running statistics -> ``weight`` / ``bias``
    / ``running_*`` (torch BatchNorm) or ``scale`` / ``bias`` / ``mean`` /
    ``var`` (MaskedBatchNorm); LayerNorm weight / bias.

`load_reference_checkpoint` reads the file with ``torch.load(weights_only=
True)``. The reference's torch-free unpickler (utils/torch_ckpt.py) has no
counterpart: the port has torch.
"""

from __future__ import annotations

from pathlib import Path

import torch


# ------------------------------------------------------------- transforms

def t_spconv(w):
    """A spconv weight -> (K, I, O): v2 (O, kz, ky, kx, I) unless only the
    v1 reading (kz, ky, kx, I, O) has kernel-sized leading axes (<= 7);
    when both do (tiny channels), v2, as spconv2 checkpoints dominate."""
    if w.ndim != 5:
        raise ValueError(f"spconv weight must be 5D, got {tuple(w.shape)}")
    small_v2 = all(d <= 7 for d in w.shape[1:4])
    small_v1 = all(d <= 7 for d in w.shape[0:3])
    if small_v2 or not small_v1:
        w = w.permute(1, 2, 3, 4, 0)        # (kz, ky, kx, I, O)
    return w.reshape(-1, w.shape[3], w.shape[4])


def t_identity(w):
    return w


def t_linear(w):
    """Linear (O, I) as it is; a kernel-1 Conv1d (O, I, 1) squeezed."""
    return w[:, :, 0] if w.ndim == 3 else w


def split_in_proj(which):
    """One of the q / k / v thirds of nn.MultiheadAttention's in_proj
    weight (3D, D) or bias (3D,)."""
    i = "qkv".index(which)

    def f(w):
        d = w.shape[0] // 3
        return w[i * d:(i + 1) * d]
    return f


# ------------------------------------------------------------- the rules

def _bn_rules(torch_prefix, port_prefix, masked=False):
    names = (("scale", "mean", "var") if masked
             else ("weight", "running_mean", "running_var"))
    rules = [(f"{torch_prefix}.weight", f"{port_prefix}.{names[0]}",
              t_identity),
             (f"{torch_prefix}.bias", f"{port_prefix}.bias", t_identity),
             (f"{torch_prefix}.running_mean", f"{port_prefix}.{names[1]}",
              t_identity),
             (f"{torch_prefix}.running_var", f"{port_prefix}.{names[2]}",
              t_identity)]
    if not masked:
        rules.append((f"{torch_prefix}.num_batches_tracked",
                      f"{port_prefix}.num_batches_tracked", t_identity))
    return rules


def _lin(torch_prefix, port_prefix, tr=t_linear):
    """A layer's weight (through `tr`) and bias."""
    return [(f"{torch_prefix}.weight", f"{port_prefix}.weight", tr),
            (f"{torch_prefix}.bias", f"{port_prefix}.bias", t_identity)]


def transfusion_rules(model_cfg) -> list:
    """(reference key, port key, transform) rules for TransFusion-LiDAR:
    VoxelResBackBone8x, BaseBEVBackbone, TransFusionHead (MeanVFE has no
    parameters)."""
    rules = [("backbone_3d.conv_input.0.weight", "backbone_3d.w_input.kernel",
              t_spconv)]
    rules += _bn_rules("backbone_3d.conv_input.1", "backbone_3d.bn_input",
                       masked=True)
    for s in (1, 2, 3, 4):
        off = 0
        if s >= 2:      # a stage opens with SparseConv3d, BN, ReLU
            rules.append((f"backbone_3d.conv{s}.0.0.weight",
                          f"backbone_3d.blocks{s}_down.kernel", t_spconv))
            rules += _bn_rules(f"backbone_3d.conv{s}.0.1",
                               f"backbone_3d.blocks{s}_down_bn", masked=True)
            off = 1
        for b in (0, 1):        # SparseBasicBlocks
            tb = f"backbone_3d.conv{s}.{b + off}"
            pb = f"backbone_3d.blocks{s}_res{b}"
            for cc in ("1", "2"):
                rules.append((f"{tb}.conv{cc}.weight",
                              f"{pb}_conv{cc}.kernel", t_spconv))
                # the reference's residual convs may carry a bias
                rules.append((f"{tb}.conv{cc}.bias", f"{pb}_conv{cc}.bias",
                              t_identity))
                rules += _bn_rules(f"{tb}.bn{cc}", f"{pb}_bn{cc}",
                                   masked=True)
    rules.append(("backbone_3d.conv_out.0.weight", "backbone_3d.w_out.kernel",
                  t_spconv))
    rules += _bn_rules("backbone_3d.conv_out.1", "backbone_3d.bn_out",
                       masked=True)

    bev = model_cfg.get("BACKBONE_2D", {})
    up = list(bev.get("UPSAMPLE_STRIDES", []))
    for i, n in enumerate(bev.get("LAYER_NUMS", [])):
        rules.append((f"backbone_2d.blocks.{i}.1.weight",
                      f"backbone_2d.block{i}_down.Conv_0.weight",
                      t_identity))
        rules += _bn_rules(f"backbone_2d.blocks.{i}.2",
                           f"backbone_2d.block{i}_down.BatchNorm_0")
        for j in range(int(n)):
            rules.append((f"backbone_2d.blocks.{i}.{4 + 3 * j}.weight",
                          f"backbone_2d.block{i}_conv{j}.Conv_0.weight",
                          t_identity))
            rules += _bn_rules(f"backbone_2d.blocks.{i}.{5 + 3 * j}",
                               f"backbone_2d.block{i}_conv{j}.BatchNorm_0")
        if i < len(up):
            kind = "ConvTranspose_0" if float(up[i]) >= 1 else "Conv_0"
            rules.append((f"backbone_2d.deblocks.{i}.0.weight",
                          f"backbone_2d.deblock{i}.{kind}.weight",
                          t_identity))
            rules += _bn_rules(f"backbone_2d.deblocks.{i}.1",
                               f"backbone_2d.deblock{i}.BatchNorm_0")

    h = "dense_head"
    rules += _lin(f"{h}.shared_conv", f"{h}.shared_conv", t_identity)
    rules += _lin(f"{h}.heatmap_head.0.conv", f"{h}.hm_block_conv",
                  t_identity)
    rules += _bn_rules(f"{h}.heatmap_head.0.bn", f"{h}.hm_block_bn")
    rules += _lin(f"{h}.heatmap_head.1", f"{h}.hm_out", t_identity)
    rules += _lin(f"{h}.class_encoding", f"{h}.class_encoding")
    for tname, pname in (("self_attn", "self_attn"),
                         ("multihead_attn", "cross_attn")):
        for which, proj in zip("qkv", ("query", "key", "value")):
            for leaf in ("weight", "bias"):
                rules.append((f"{h}.decoder.{tname}.in_proj_{leaf}",
                              f"{h}.decoder.{pname}.{proj}.{leaf}",
                              split_in_proj(which)))
        rules += _lin(f"{h}.decoder.{tname}.out_proj",
                      f"{h}.decoder.{pname}.out")
    for i in (1, 2, 3):
        rules += _lin(f"{h}.decoder.norm{i}", f"{h}.decoder.norm{i}",
                      t_identity)
    for i in (1, 2):
        rules += _lin(f"{h}.decoder.linear{i}", f"{h}.decoder.linear{i}")
    for emb in ("self_posembed", "cross_posembed"):
        pe = f"{h}.decoder.{emb}.position_embedding_head"
        pp = f"{h}.decoder.{emb}"
        rules += _lin(f"{pe}.0", f"{pp}.Dense_0")
        rules += _bn_rules(f"{pe}.1", f"{pp}.BatchNorm_0")
        rules += _lin(f"{pe}.3", f"{pp}.Dense_1")

    dh = model_cfg.get("DENSE_HEAD", {})
    heads = dict(dh.get("SEPARATE_HEAD_CFG", {}).get("HEAD_DICT", {}))
    heads["heatmap"] = {"num_conv": int(dh.get("NUM_HM_CONV", 2))}
    for name, hc in heads.items():
        n_conv = int(hc.get("num_conv", 2))
        tb = f"{h}.prediction_head.{name}"
        pb = f"{h}.prediction_head.{name}"
        for j in range(n_conv - 1):
            rules += _lin(f"{tb}.{j}.0", f"{pb}_fc{j}")
            rules += _bn_rules(f"{tb}.{j}.1", f"{pb}_bn{j}")
        rules += _lin(f"{tb}.{n_conv - 1}", f"{pb}_out")
    return rules


# ------------------------------------------------------------- application

def _excluded(key):
    """Reference keys with no place in the model (the reference's own
    exclusions): BN batch counters, the BEV positional buffer, the VLM's
    weights, anchors."""
    return (key.endswith("num_batches_tracked") or "bev_pos" in key
            or key.startswith("vlm") or "anchors" in key)


@torch.no_grad()
def import_state_dict(state_dict, detector, rules):
    """Apply the rules to `detector` in place; returns the reference's
    report: ``loaded`` [(reference key, port key)], ``unmatched_torch``
    (reference keys no rule used, less the exclusions) and ``mismatched``
    [(reference key, port key, shape given, shape wanted)]."""
    targets = dict(detector.state_dict(keep_vars=True))
    used, loaded, mismatched = set(), [], []
    for tkey, pkey, tr in rules:
        if tkey not in state_dict or pkey not in targets:
            continue
        target = targets[pkey]
        val = tr(torch.as_tensor(state_dict[tkey]))
        if tuple(val.shape) != tuple(target.shape):
            mismatched.append((tkey, pkey, tuple(val.shape),
                               tuple(target.shape)))
            continue
        target.copy_(val.to(device=target.device, dtype=target.dtype))
        used.add(tkey)
        loaded.append((tkey, pkey))
    unmatched = [k for k in state_dict
                 if k not in used and not _excluded(k)]
    return {"loaded": loaded, "unmatched_torch": unmatched,
            "mismatched": mismatched}


def load_reference_checkpoint(path, detector, model_cfg):
    """A reference ``.pth`` (``{"model_state": ...}`` or a bare state
    dict) into the port's TransFusion `detector`; returns the report."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    state = ckpt.get("model_state", ckpt)
    return import_state_dict(state, detector, transfusion_rules(model_cfg))
