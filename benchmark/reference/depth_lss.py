"""Frozen copy of the port's findnpropagate_torch/models/view_transforms/depth_lss.py, kept under the
benchmark so that a change to the program cannot move the yardstick.

DepthLSSTransform, lift-splat-shoot with lidar depth — port of
findnpropagate_tpu/models/view_transforms/depth_lss.py (`DepthLSSTransform`
:27, `get_geometry` :70-83, `rasterize_depth` :85-120, `__call__`
:122-173).

Per camera the lidar points are projected into a sparse depth map (the
largest depth wins a pixel: a scatter-max from zero, as the reference's),
encoded by ``dt_layers``, concatenated with the FPN's first
map, and ``dn_layers`` + ``dn_out`` predict D depth bins and C context
channels; the outer product of the depth softmax and the context is lifted
along the frustum (image u, v and the DBOUND depths, the image and
lidar augmentations undone) into lidar space and splat into the BEV grid
(`ops/bev_pool.py`), then ``ds_layers`` downsample it (DOWNSAMPLE > 1).
Every conv has a bias and flax's SAME padding, every BN is flax's (eps
1e-5). NCHW; ``spatial_features_img`` is (B, C', ny, nx) with C' = C
after a downsample, else nz * C (z * C + c).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .bev_pool import bev_pool
from .blocks import BatchNorm2d, same_pad

BN_EPS = 1e-5      # flax nn.BatchNorm's


class DepthLSSTransform(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        cfg = model_cfg
        self.image_size = tuple(int(v) for v in cfg["IMAGE_SIZE"])
        self.feature_size = tuple(int(v) for v in cfg["FEATURE_SIZE"])
        self.xbound = [float(v) for v in cfg["XBOUND"]]
        self.ybound = [float(v) for v in cfg["YBOUND"]]
        self.zbound = [float(v) for v in cfg["ZBOUND"]]
        self.dbound = [float(v) for v in cfg["DBOUND"]]
        self.C = int(cfg["OUT_CHANNEL"])
        steps = lambda b: int(round((b[1] - b[0]) / b[2]))  # noqa: E731
        self.D = steps(self.dbound)
        self.nx, self.ny, self.nz = (steps(self.xbound), steps(self.ybound),
                                     steps(self.zbound))
        self.downsample_factor = int(cfg.get("DOWNSAMPLE", 1))
        cin = int(cfg["IN_CHANNEL"])
        self.dt_layers = self._stack("dt_layers", [(1, 8, 1, 1),
                                                   (8, 32, 5, 4),
                                                   (32, 64, 5, 2)])
        self.dn_layers = self._stack("dn_layers", [(64 + cin, cin, 3, 1),
                                                   (cin, cin, 3, 1)])
        self.dn_out = nn.Conv2d(cin, self.D + self.C, 1)
        self.ds_layers = []
        if self.downsample_factor > 1:
            c = self.C
            self.ds_layers = self._stack("ds_layers", [
                (self.nz * c, c, 3, 1), (c, c, 3, 2), (c, c, 3, 1)])
        self.out_channels = self.C if self.downsample_factor > 1 \
            else self.nz * self.C
        self.register_buffer("frustum_grid", self._frustum(),
                             persistent=False)

    def _stack(self, name, specs):
        """conv + BN layers under the flax names {name}_{i}_0 / _1; the
        list of (conv, bn, kernel, stride)."""
        layers = []
        for i, (cin, cout, k, s) in enumerate(specs):
            conv = nn.Conv2d(cin, cout, k, s)
            bn = BatchNorm2d(cout, eps=BN_EPS)
            self.add_module(f"{name}_{i}_0", conv)
            self.add_module(f"{name}_{i}_1", bn)
            layers.append((conv, bn, k, s))
        return layers

    @staticmethod
    def _run(layers, x):
        for conv, bn, k, s in layers:
            x = torch.relu(bn(conv(same_pad(x, k, s))))
        return x

    def _frustum(self):
        """(D, fH, fW, 3) [u, v, depth] of the feature map's cells."""
        ih, iw = self.image_size
        fh, fw = self.feature_size
        ds = np.arange(self.dbound[0], self.dbound[1], self.dbound[2])
        g = np.zeros((len(ds), fh, fw, 3), np.float32)
        g[..., 0] = np.linspace(0, iw - 1, fw)[None, None, :]
        g[..., 1] = np.linspace(0, ih - 1, fh)[None, :, None]
        g[..., 2] = ds[:, None, None]
        return torch.from_numpy(g)

    def get_geometry(self, c2l, intr, img_aug, lidar_aug):
        """c2l / intr / img_aug (..., 4, 4), lidar_aug broadcastable to
        them -> (..., D, fH, fW, 3) lidar xyz of the frustum's points."""
        f = self.frustum_grid.to(c2l.dtype)
        lead = c2l.shape[:-2]
        pts = f.reshape(-1, 3) - img_aug[..., None, :3, 3]
        pts = pts @ torch.linalg.inv(img_aug[..., :3, :3]).transpose(-1, -2)
        pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
        combine = c2l[..., :3, :3] @ torch.linalg.inv(intr[..., :3, :3])
        pts = pts @ combine.transpose(-1, -2) + c2l[..., None, :3, 3]
        pts = pts @ lidar_aug[..., :3, :3].transpose(-1, -2) \
            + lidar_aug[..., None, :3, 3]
        return pts.reshape(lead + tuple(f.shape))

    def rasterize_depth(self, points, points_mask, l2i, img_aug, lidar_aug):
        """points (B, P, 3); l2i / img_aug (B, N, 4, 4); lidar_aug
        (B, 4, 4). Returns (B, N, H, W): per pixel the largest depth of the
        points projected there, 0 where none."""
        ih, iw = self.image_size
        pts = points - lidar_aug[:, None, :3, 3]
        pts = pts @ torch.linalg.inv(lidar_aug[:, :3, :3]).transpose(1, 2)
        cam = pts[:, None] @ l2i[..., :3, :3].transpose(-1, -2) \
            + l2i[..., None, :3, 3]                       # (B, N, P, 3)
        dist = cam[..., 2]
        z = torch.clamp(dist, 1e-5, 1e5)
        uv1 = torch.cat([cam[..., :2] / z[..., None],
                         torch.ones_like(z)[..., None]], -1)
        uv = uv1 @ img_aug[..., :3, :3].transpose(-1, -2) \
            + img_aug[..., None, :3, 3]
        u, v = uv[..., 0], uv[..., 1]
        on = (points_mask[:, None] & (dist > 0) & (u >= 0) & (u < iw)
              & (v >= 0) & (v < ih))
        ui = torch.clamp(u.to(torch.int32), 0, iw - 1).long()
        vi = torch.clamp(v.to(torch.int32), 0, ih - 1).long()
        flat = torch.where(on, vi * iw + ui, torch.full_like(ui, ih * iw))
        b, n = flat.shape[:2]
        d = dist.new_zeros(b, n, ih * iw + 1).scatter_reduce(
            2, flat, torch.where(on, dist, torch.zeros_like(dist)), "amax")
        return d[..., :-1].reshape(b, n, ih, iw)

    def forward(self, batch):
        feats = batch["image_fpn"][0]                  # (B*N, Cin, fH, fW)
        c2l = batch["camera2lidar"].float()
        b, ncam = c2l.shape[:2]
        eye = torch.eye(4, device=c2l.device)
        lidar_aug = batch.get("lidar_aug_matrix")
        lidar_aug = eye.expand(b, 4, 4) if lidar_aug is None \
            else lidar_aug.float()
        img_aug = batch.get("img_aug_matrix")
        img_aug = eye.expand(b, ncam, 4, 4) if img_aug is None \
            else img_aug.float()
        with torch.no_grad():
            depth = self.rasterize_depth(
                batch["points"][..., :3].float(), batch["points_mask"],
                batch["lidar2image"].float(), img_aug, lidar_aug)
        d = self._run(self.dt_layers, depth.reshape(
            (b * ncam, 1) + tuple(depth.shape[2:])))
        x = self._run(self.dn_layers, torch.cat([d, feats], dim=1))
        x = self.dn_out(x)                             # (B*N, D+C, fH, fW)
        probs = torch.softmax(x[:, :self.D], dim=1)
        ctx = x[:, self.D:]
        fh, fw = self.feature_size
        # (B*N, D, C, fH, fW) -> (B, N, D, fH, fW, C)
        lifted = (probs[:, :, None] * ctx[:, None]).reshape(
            b, ncam, self.D, self.C, fh, fw).permute(0, 1, 2, 4, 5, 3)
        with torch.no_grad():
            geom = self.get_geometry(c2l, batch["camera_intrinsics"].float(),
                                     img_aug, lidar_aug[:, None])
            dx = geom.new_tensor([self.xbound[2], self.ybound[2],
                                  self.zbound[2]])
            lo = geom.new_tensor([self.xbound[0], self.ybound[0],
                                  self.zbound[0]])
            cell = torch.floor((geom - lo) / dx).to(torch.int32)
        bev = bev_pool(lifted.reshape(b, -1, self.C), cell.reshape(b, -1, 3),
                       torch.ones(cell.shape[:-1], dtype=torch.bool,
                                  device=cell.device).reshape(b, -1),
                       self.nx, self.ny, self.nz)
        if self.downsample_factor > 1:
            bev = self._run(self.ds_layers, bev)
        batch["spatial_features_img"] = bev
        return batch
