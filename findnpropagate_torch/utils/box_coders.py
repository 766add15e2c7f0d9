"""Box coders — port of findnpropagate_tpu/utils/box_coders.py
(`ResidualCoder` :15-78, `PointResidualCoder` :80-133): stateless
encode / decode over the last axis, leading axes broadcast.

Boxes and anchors are (..., 7+C) = [x, y, z, dx, dy, dz, heading, ...].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _columns(x, n):
    return [x[..., i] for i in range(n)]


@dataclass(frozen=True)
class ResidualCoder:
    """Anchor deltas: centres over the anchor's BEV diagonal (z over its
    height), log dims, the heading raw or as (cos, sin) differences, and
    the extra columns as plain differences."""

    code_size: int = 7
    encode_angle_by_sincos: bool = False

    @property
    def full_code_size(self):
        return self.code_size + (1 if self.encode_angle_by_sincos else 0)

    def encode(self, boxes, anchors):
        def clip_dims(b):
            return torch.cat([b[..., 0:3], torch.clamp(b[..., 3:6], min=1e-5),
                              b[..., 6:]], dim=-1)

        anchors, boxes = clip_dims(anchors), clip_dims(boxes)
        xa, ya, za, dxa, dya, dza, ra = _columns(anchors, 7)
        xg, yg, zg, dxg, dyg, dzg, rg = _columns(boxes, 7)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        cts = [boxes[..., i] - anchors[..., i]
               for i in range(7, boxes.shape[-1])]
        return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal,
                            (zg - za) / dza, torch.log(dxg / dxa),
                            torch.log(dyg / dya), torch.log(dzg / dza),
                            *rts, *cts], dim=-1)

    def decode(self, encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = _columns(anchors, 7)
        if self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt, cost, sint = _columns(encodings, 8)
            extra_start = 8
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            xt, yt, zt, dxt, dyt, dzt, rt = _columns(encodings, 7)
            extra_start = 7
            rg = rt + ra
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        extras = [encodings[..., extra_start + i] + anchors[..., 7 + i]
                  for i in range(anchors.shape[-1] - 7)]
        return torch.stack([xt * diagonal + xa, yt * diagonal + ya,
                            zt * dza + za, torch.exp(dxt) * dxa,
                            torch.exp(dyt) * dya, torch.exp(dzt) * dza, rg,
                            *extras], dim=-1)


@dataclass(frozen=True)
class PointResidualCoder:
    """Residuals to a point, over the per-class mean size (1-indexed
    classes) when `use_mean_size`; the heading as (cos, sin)."""

    code_size: int = 8
    use_mean_size: bool = True
    mean_size: tuple = ()

    def _mean(self, classes, like):
        """The mean sizes of 1-indexed classes, indexed as the reference's
        gather does: class 0 wraps to the last row, a class past the table
        clamps to it."""
        table = torch.as_tensor(self.mean_size, dtype=like.dtype,
                                device=like.device)
        n = table.shape[0]
        idx = classes.long() - 1
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
        mean = table[idx]
        return mean[..., 0], mean[..., 1], mean[..., 2]

    def encode(self, gt_boxes, points, gt_classes=None):
        xg, yg, zg = _columns(gt_boxes, 3)
        dxg, dyg, dzg = (torch.clamp(gt_boxes[..., i], min=1e-5)
                         for i in (3, 4, 5))
        rg = gt_boxes[..., 6]
        xa, ya, za = _columns(points, 3)
        if self.use_mean_size:
            dxa, dya, dza = self._mean(gt_classes, gt_boxes)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            res = [(xg - xa) / diagonal, (yg - ya) / diagonal,
                   (zg - za) / dza, torch.log(dxg / dxa),
                   torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            res = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg),
                   torch.log(dzg)]
        extras = [gt_boxes[..., 7 + i] for i in range(gt_boxes.shape[-1] - 7)]
        return torch.stack([*res, torch.cos(rg), torch.sin(rg), *extras],
                           dim=-1)

    def decode(self, encodings, points, pred_classes=None):
        xt, yt, zt, dxt, dyt, dzt, cost, sint = _columns(encodings, 8)
        xa, ya, za = _columns(points, 3)
        if self.use_mean_size:
            dxa, dya, dza = self._mean(pred_classes, encodings)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            res = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                   torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                   torch.exp(dzt) * dza]
        else:
            res = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt),
                   torch.exp(dzt)]
        extras = [encodings[..., 8 + i]
                  for i in range(encodings.shape[-1] - 8)]
        return torch.stack([*res, torch.atan2(sint, cost), *extras], dim=-1)
