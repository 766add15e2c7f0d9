"""PointNet2MSG, PointRCNN's point encoder — port of
findnpropagate_tpu/models/backbones_3d/pointnet2_backbone.py (`_MLP` :32,
`SAModuleMSG` :50, `FPModule` :100, `PointNet2MSG` :124).

Over the padded (B, P) point list with its mask: set-abstraction levels
(farthest point sampling of NPOINTS centres, then per radius a ball query
of NSAMPLE points grouped relative to the centre, a shared Linear (no
bias) + masked BN + ReLU MLP, and the max over the group — 0 for an empty
ball — concatenated over the radii), then feature propagation back to
every point (three-NN inverse-distance interpolation, concatenated with
the level's own features, and an MLP). Over ops/pointnet2.py; FPS is its
loop of device operations. Names: ``sa{k}/radius{r}/mlp{i}`` (+ ``_bn``),
``fp{k}/fp/mlp{i}``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.pointnet2 import (
    farthest_point_sample,
    query_and_group,
    three_interpolate,
    three_nn,
)
from ..blocks import MaskedBatchNorm


class MLP(nn.Module):
    """Linear (no bias) + masked BN + ReLU layers ``{prefix}{i}`` /
    ``{prefix}{i}_bn``."""

    def __init__(self, cin, channels, prefix="mlp"):
        super().__init__()
        self.names = []
        for i, ch in enumerate(channels):
            self.add_module(f"{prefix}{i}", nn.Linear(int(cin), int(ch),
                                                      bias=False))
            self.add_module(f"{prefix}{i}_bn", MaskedBatchNorm(int(ch)))
            self.names.append(f"{prefix}{i}")
            cin = int(ch)
        self.out_channels = int(cin)

    def forward(self, x, valid):
        for n in self.names:
            x = torch.relu(getattr(self, f"{n}_bn")(
                getattr(self, n)(x), valid, channels_last=True))
        return x


def sample_centers(xyz, mask, npoint):
    """FPS of `npoint` centres: (centres (B, M, 3), their mask — the
    first min(M, valid) slots)."""
    idx = farthest_point_sample(xyz, mask, npoint)
    centers = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    n_valid = mask.sum(dim=1, keepdim=True)
    return centers, torch.arange(npoint, device=xyz.device) < n_valid


class SAModuleMSG(nn.Module):
    def __init__(self, cin, npoint, radii, nsamples, mlps):
        super().__init__()
        self.npoint = int(npoint)
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(n) for n in nsamples]
        for ri, mlp in enumerate(mlps):
            self.add_module(f"radius{ri}", MLP(3 + cin, mlp))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, mask, feats):
        """xyz (B, P, 3), feats (B, P, C) or None -> (new_xyz (B, M, 3),
        new_mask (B, M), new_feats (B, M, C'))."""
        new_xyz, new_mask = sample_centers(xyz, mask, self.npoint)
        outs = []
        for ri, (radius, ns) in enumerate(zip(self.radii, self.nsamples)):
            grouped, cnt = query_and_group(new_xyz, new_mask, xyz, mask,
                                           feats, radius, ns)
            b, m, s, c = grouped.shape
            h = getattr(self, f"radius{ri}")(
                grouped.reshape(b, m * s, c),
                new_mask.repeat_interleave(s, dim=1)).reshape(b, m, s, -1)
            # an empty ball maxes to 0
            h = torch.where((cnt > 0)[..., None, None], h,
                            torch.zeros_like(h))
            outs.append(h.amax(dim=2))
        new_feats = torch.cat(outs, dim=-1)
        return new_xyz, new_mask, torch.where(
            new_mask[..., None], new_feats, torch.zeros_like(new_feats))


class FPModule(nn.Module):
    def __init__(self, cin, mlp):
        super().__init__()
        self.fp = MLP(cin, mlp)

    def forward(self, unknown, unknown_mask, known, known_mask,
                unknown_feats, known_feats):
        dist, idx = three_nn(unknown, unknown_mask, known, known_mask)
        x = three_interpolate(known_feats, idx, dist)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], dim=-1)
        x = self.fp(x, unknown_mask)
        return torch.where(unknown_mask[..., None], x, torch.zeros_like(x))


class PointNet2MSG(nn.Module):
    def __init__(self, model_cfg, input_channels, grid_size=(),
                 voxel_size=None, point_cloud_range=None):
        # the voxel grid's arguments every 3D backbone takes: unused, the
        # raw points are its input
        super().__init__()
        self.model_cfg = model_cfg
        sa = model_cfg["SA_CONFIG"]
        skip = [int(input_channels) - 3]
        for k, npoint in enumerate(sa["NPOINTS"]):
            mod = SAModuleMSG(skip[-1], npoint, sa["RADIUS"][k],
                              sa["NSAMPLE"][k], sa["MLPS"][k])
            self.add_module(f"sa{k}", mod)
            skip.append(mod.out_channels)
        self.n_sa = len(sa["NPOINTS"])
        fp = model_cfg["FP_MLPS"]
        self.n_fp = len(fp)
        # fp module k merges level k + 1 (as refined by fp k + 1, or as the
        # SA level left it) into level k
        width = {self.n_sa: skip[self.n_sa]}
        for k in range(self.n_fp - 1, -1, -1):
            lvl = k + self.n_sa - self.n_fp
            self.add_module(f"fp{k}", FPModule(width[lvl + 1] + skip[lvl],
                                               fp[k]))
            width[lvl] = int(fp[k][-1])
        self._out_channels = int(fp[0][-1])

    @property
    def num_point_features(self):
        return self._out_channels

    @property
    def num_bev_features(self):
        return self._out_channels

    def forward(self, batch):
        points = batch["points"]
        mask = batch["points_mask"]
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_mask, l_feats = [xyz], [mask], [feats]
        for k in range(self.n_sa):
            nx, nm, nf = getattr(self, f"sa{k}")(l_xyz[-1], l_mask[-1],
                                                 l_feats[-1])
            l_xyz.append(nx)
            l_mask.append(nm)
            l_feats.append(nf)
        for j in range(1, self.n_fp + 1):
            i = -j
            l_feats[i - 1] = getattr(self, f"fp{self.n_fp - j}")(
                l_xyz[i - 1], l_mask[i - 1], l_xyz[i], l_mask[i],
                l_feats[i - 1], l_feats[i])
        batch["point_features"] = l_feats[0]
        batch["point_coords"] = xyz
        batch["point_valid"] = mask
        return batch
