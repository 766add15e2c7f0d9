"""ImageVFE, CaDDN's camera-only voxel feature encoder — port of
findnpropagate_tpu/models/vfe/image_vfe.py (`bin_depths` :29, `ImageVFE`
:58-152, `ddn_loss` :154-210).

A conv encoder (3x3 stride-2 convs to FFN.STRIDE, then a 3x3 conv, each
without bias + BN (flax's, eps 1e-5) + ReLU, flax's SAME padding) gives C
channels at the image's 1/STRIDE; ``depth_head`` (1x1, bias) gives
num_bins + 1 depth logits (the last bin: out of range). The frustum is the
features times the softmax over the first num_bins bins. Every voxel
centre of the grid is projected through ``trans_lidar_to_cam`` and
``trans_cam_to_img``, its depth binned (`bin_depths`: LID, UD or SID) and
the frustum sampled trilinearly at (v, u, bin) with half-pixel centres
(corners clamped into the frustum, zero where the point falls outside it,
behind the camera or outside the discretisation's domain). NCHW:
``depth_logits`` (B, D+1, h, w), ``voxel_features_dense`` (B, C, nz, ny,
nx), the layout of a sparse backbone's dense output.

`ddn_loss`: the focal cross-entropy of the depth logits against the
lidar points binned per pixel (the nearest return's bin wins: scatter-min,
as the reference's ``.at[].min``), over the pixels with a return, times
LOSS.WEIGHT.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNorm2d, same_pad

BN_EPS = 1e-5      # flax nn.BatchNorm's


def bin_depths(depth, mode, depth_min, depth_max, num_bins,
               with_valid=False):
    """Continuous depth -> fractional bin index; with_valid also the
    discretisation's domain (the reference clamps the domain and masks
    with it, where the original's sqrt / log gives NaN)."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        idx = (depth - depth_min) / bin_size
        valid = torch.ones_like(depth, dtype=torch.bool)
    elif mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        arg = 1 + 8 * (depth - depth_min) / bin_size
        valid = arg > 0
        idx = -0.5 + 0.5 * torch.sqrt(torch.clamp(arg, min=1e-6))
    elif mode == "SID":
        valid = depth > -1
        idx = num_bins * (
            torch.log1p(torch.clamp(depth, min=-1 + 1e-6))
            - float(np.log(1 + depth_min))) / float(
                np.log(1 + depth_max) - np.log(1 + depth_min))
    else:
        raise NotImplementedError(mode)
    return (idx, valid) if with_valid else idx


def _disc(cfg):
    disc = cfg["DISC_CFG"]
    return (str(disc.get("mode", "LID")), float(disc["depth_min"]),
            float(disc["depth_max"]), int(disc["num_bins"]))


def _project(points, l2c, c2i):
    """points (B, P, 3) -> (depth, u, v) through (B, 4, 4) / (B, 3, 4)."""
    cam = points @ l2c[:, :3, :3].transpose(1, 2) + l2c[:, None, :3, 3]
    proj = cam @ c2i[:, :3, :3].transpose(1, 2) + c2i[:, None, :3, 3]
    depth = proj[..., 2]
    z = torch.clamp(depth, min=1e-5)
    return depth, proj[..., 0] / z, proj[..., 1] / z


class ImageVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features=0, voxel_size=(),
                 point_cloud_range=(), grid_size=()):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        ffn = cfg["FFN"]
        self.output_dim = ch = int(ffn.get("CHANNELS", 32))
        self.stride = int(ffn.get("STRIDE", 4))
        self.mode, self.d_min, self.d_max, self.num_bins = _disc(cfg)
        self.n_down, s, cin = 0, 1, 3
        while s < self.stride:
            self._pair(self.n_down, cin, ch, 2)
            cin, s, self.n_down = ch, 2 * s, self.n_down + 1
        self._pair(self.n_down, cin, ch, 1)
        self.depth_head = nn.Conv2d(ch, self.num_bins + 1, 1)
        self.grid_size = tuple(int(g) for g in grid_size)
        nx, ny, nz = self.grid_size
        vs, pcr = voxel_size, point_cloud_range
        axes = [(np.arange(n) + 0.5) * vs[i] + pcr[i]
                for i, n in enumerate((nx, ny, nz))]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        self.register_buffer("centres", torch.from_numpy(
            g.astype(np.float32)), persistent=False)

    def _pair(self, i, cin, cout, stride):
        self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, 3, stride,
                                               bias=False))
        self.add_module(f"BatchNorm_{i}", BatchNorm2d(cout, eps=BN_EPS))

    def forward(self, batch):
        imgs = batch["camera_imgs"].float()
        if imgs.ndim == 5:                      # (B, 1, H, W, 3)
            imgs = imgs[:, 0]
        x = imgs.permute(0, 3, 1, 2)
        for i in range(self.n_down + 1):
            conv = getattr(self, f"Conv_{i}")
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(conv(same_pad(
                x, 3, conv.stride[0]))))
        logits = self.depth_head(x)             # (B, D+1, h, w)
        batch["depth_logits"] = logits
        probs = torch.softmax(logits, dim=1)[:, :self.num_bins]
        b, c, h_f, w_f = x.shape
        # (B, h, w, D, C): features x depth distribution
        frustum = (probs[:, :, None] * x[:, None]).permute(0, 3, 4, 1, 2)
        batch["voxel_features_dense"] = self._sample(
            frustum, batch["trans_lidar_to_cam"].float(),
            batch["trans_cam_to_img"].float())
        return batch

    def _sample(self, frustum, l2c, c2i):
        """Trilinear sample of (B, h, w, D, C) at every voxel centre ->
        (B, C, nz, ny, nx)."""
        b, h_f, w_f, nb, c = frustum.shape
        with torch.no_grad():
            ctr = self.centres.expand(b, -1, -1)
            depth, u, v = _project(ctr, l2c, c2i)
            uf = u / self.stride - 0.5
            vf = v / self.stride - 0.5
            df, dok = bin_depths(depth, self.mode, self.d_min, self.d_max,
                                 nb, with_valid=True)
            ok = (dok & (depth > 0) & (uf > -1) & (uf < w_f) & (vf > -1)
                  & (vf < h_f) & (df > -1) & (df < nb))
            u0, v0, d0 = (torch.floor(t) for t in (uf, vf, df))
            ua, va, da = uf - u0, vf - v0, df - d0
            u0, v0, d0 = (t.long() for t in (u0, v0, d0))
        flat = frustum.reshape(b, -1, c)
        bidx = torch.arange(b, device=flat.device)[:, None]
        out = 0.0
        for dv, wv in ((0, 1 - va), (1, va)):
            vi = torch.clamp(v0 + dv, 0, h_f - 1)
            for du, wu in ((0, 1 - ua), (1, ua)):
                ui = torch.clamp(u0 + du, 0, w_f - 1)
                for dd, wd in ((0, 1 - da), (1, da)):
                    di = torch.clamp(d0 + dd, 0, nb - 1)
                    out = out + flat[bidx, (vi * w_f + ui) * nb + di] * (
                        wv * wu * wd)[..., None]
        out = torch.where(ok[..., None], out, torch.zeros_like(out))
        nx, ny, nz = self.grid_size
        return out.reshape(b, nx, ny, nz, c).permute(0, 4, 3, 2, 1)


def ddn_loss(out_batch, model_cfg):
    """Depth-distribution supervision: (loss, {"depth_loss": loss})."""
    cfg = model_cfg
    mode, d_min, d_max, num_bins = _disc(cfg)
    stride = int(cfg["FFN"].get("STRIDE", 4))
    w_depth = float(cfg.get("LOSS", {}).get("WEIGHT", 3.0))
    gamma = float(cfg.get("LOSS", {}).get("GAMMA", 2.0))
    logits = out_batch["depth_logits"]          # (B, D+1, h, w)
    b, _, h, w = logits.shape
    with torch.no_grad():
        depth, u, v = _project(out_batch["points"][..., :3].float(),
                               out_batch["trans_lidar_to_cam"].float(),
                               out_batch["trans_cam_to_img"].float())
        u = (u / stride).to(torch.int32).long()
        v = (v / stride).to(torch.int32).long()
        ok = (out_batch["points_mask"] & (depth > 0) & (u >= 0) & (u < w)
              & (v >= 0) & (v < h))
        idx, iok = bin_depths(depth, mode, d_min, d_max, num_bins,
                              with_valid=True)
        tgt_bin = torch.clamp(torch.floor(idx), 0, num_bins).long()
        tgt_bin = torch.where(~iok | (idx < 0) | (idx > num_bins),
                              torch.full_like(tgt_bin, num_bins), tgt_bin)
        flat = torch.where(ok, v * w + u, torch.full_like(u, h * w))
        inf = torch.full((b, h * w + 1), float("inf"), device=depth.device)
        depth_map = inf.scatter_reduce(1, flat, torch.where(
            ok, depth, torch.full_like(depth, float("inf"))), "amin")
        bin_map = torch.full((b, h * w + 1), num_bins, dtype=torch.long,
                             device=depth.device).scatter_reduce(
            1, flat, torch.where(ok, tgt_bin,
                                 torch.full_like(tgt_bin, num_bins)), "amin")
        tgt = bin_map[:, :-1].reshape(b, h, w)
        has = torch.isfinite(depth_map[:, :-1]).reshape(b, h, w).float()
    logp = F.log_softmax(logits.float(), dim=1)
    logp_t = torch.gather(logp, 1, tgt[:, None])[:, 0]
    ce = -logp_t
    pt = torch.exp(logp_t)
    focal = torch.clamp(1 - pt, min=0.0) ** gamma * ce
    loss = (focal * has).sum() / torch.clamp(has.sum(), min=1.0) * w_depth
    return loss, {"depth_loss": loss}
