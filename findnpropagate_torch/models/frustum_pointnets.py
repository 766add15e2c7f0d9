"""Frustum PointNets v1 — port of
findnpropagate_tpu/models/frustum_pointnets.py (`PointNetInstanceSeg`
:27-58, the SEG seeker's foreground filter; `STNxyz` :71,
`PointNetEstimation` :91, `FrustumPointNetv1` :114, the heading / size
codec :174-201 and `frustum_pointnet_loss` :213).

Conv1d(k=1) is a Linear over the point axis; points are (B, N, C) with a
validity mask, every BatchNorm a MaskedBatchNorm over the valid points
(the fully connected layers' over every row). The reference's resampling
of the predicted foreground to a fixed count is a mask here, exact for the
per-point MLPs and the masked max that follow it. Layer names are the
flax tree's (``enc0_fc0``, ``enc0_bn0``, ..., ``seg_out``, ``ins_seg``,
``stn``, ``est``, ``fc0`` / ``fbn0``, ``fc_out``), so utils/weights.py
carries a flax variables tree across.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import MaskedBatchNorm

NEG_INF = -1e9


def _masked_max(x, valid):
    """(..., N, C) max over the valid N (NEG_INF where none is)."""
    return torch.where(valid[..., None], x,
                       torch.full_like(x, NEG_INF)).amax(-2)


class _MLPStacks(nn.Module):
    """Per prefix of STACKS a Linear + MaskedBatchNorm + ReLU stack
    (``{prefix}_fc{i}``, ``{prefix}_bn{i}``); ``cin`` its input widths."""

    STACKS = ()

    def _build_stacks(self, cin):
        for prefix, dims in self.STACKS:
            c = cin[prefix]
            for i, d in enumerate(dims):
                setattr(self, f"{prefix}_fc{i}", nn.Linear(c, d))
                setattr(self, f"{prefix}_bn{i}", MaskedBatchNorm(d))
                c = d

    def _stack(self, x, valid, prefix):
        dims = dict(self.STACKS)[prefix]
        for i in range(len(dims)):
            x = getattr(self, f"{prefix}_fc{i}")(x)
            x = getattr(self, f"{prefix}_bn{i}")(x, valid, channels_last=True)
            x = torch.relu(x)
        return x


class PointNetInstanceSeg(_MLPStacks):
    """Per-point FG/BG segmentation: encoder 64-64-64-128-1024, global max
    and the class one-hot, skip from the 2nd layer, decoder
    512-256-128-128-2. Dropout(0.5) before the last layer, in training
    only."""

    STACKS = (("enc0", (64,)), ("enc1", (64,)), ("enc2", (64, 128, 1024)),
              ("dec", (512, 256, 128, 128)))

    def __init__(self, n_classes: int = 3):
        super().__init__()
        self.n_classes = n_classes
        self._build_stacks({"enc0": 3, "enc1": 64, "enc2": 64,
                            "dec": 64 + 1024 + n_classes})
        self.dropout = nn.Dropout(0.5)
        self.seg_out = nn.Linear(128, 2)

    def forward(self, pts, one_hot, valid):
        """pts (B, N, 3); one_hot (B, C); valid (B, N) -> logits (B, N, 2)."""
        out2 = self._stack(self._stack(pts, valid, "enc0"), valid, "enc1")
        x = self._stack(out2, valid, "enc2")
        glob = torch.cat([_masked_max(x, valid), one_hot.to(x.dtype)], dim=-1)
        x = torch.cat([out2, glob[:, None, :].expand(
            *out2.shape[:-1], glob.shape[-1])], dim=-1)
        x = self.dropout(self._stack(x, valid, "dec"))
        return self.seg_out(x)


class _GlobalHead(_MLPStacks):
    """Encoder stack, masked max, the one-hot, two fully connected layers
    with BN over the rows, a last Linear."""

    def __init__(self, n_classes, enc, fcs, out):
        super().__init__()
        self.STACKS = (("enc", enc),)
        self._build_stacks({"enc": 3})
        c = enc[-1] + n_classes
        for i, d in enumerate(fcs):
            setattr(self, f"fc{i}", nn.Linear(c, d))
            setattr(self, f"fbn{i}", MaskedBatchNorm(d))
            c = d
        self.n_fc = len(fcs)
        self.fc_out = nn.Linear(c, out)

    def forward(self, pts, one_hot, valid):
        x = _masked_max(self._stack(pts, valid, "enc"), valid)
        x = torch.cat([x, one_hot.to(x.dtype)], dim=-1)
        rows = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"fbn{i}")(
                getattr(self, f"fc{i}")(x), rows, channels_last=True))
        return self.fc_out(x)


class STNxyz(_GlobalHead):
    """T-Net centre regression: encoder 128-128-256, fc 256-128 -> 3; the
    last layer zero-initialised."""

    def __init__(self, n_classes: int = 3):
        super().__init__(n_classes, (128, 128, 256), (256, 128), 3)
        nn.init.zeros_(self.fc_out.weight)
        nn.init.zeros_(self.fc_out.bias)


class PointNetEstimation(_GlobalHead):
    """Amodal box estimation: encoder 128-128-256-512, fc 512-256 -> 3 +
    2 * NH + 4 * NS raw outputs."""

    def __init__(self, n_classes: int = 3, n_heading_bin: int = 12,
                 n_size_cluster: int = 3):
        super().__init__(n_classes, (128, 128, 256, 512), (512, 256),
                         3 + 2 * n_heading_bin + 4 * n_size_cluster)


class FrustumPointNetv1(nn.Module):
    """Segmentation -> masked centroid -> T-Net -> box estimation.
    `size_anchors`: the (NS, 3) anchor sizes."""

    def __init__(self, n_classes: int = 3, n_heading_bin: int = 12,
                 size_anchors=((3.9, 1.6, 1.56),)):
        super().__init__()
        self.n_heading_bin = n_heading_bin
        self.register_buffer("anchors", torch.tensor(size_anchors,
                                                     dtype=torch.float32),
                             persistent=False)
        ns = len(size_anchors)
        self.ins_seg = PointNetInstanceSeg(n_classes)
        self.stn = STNxyz(n_classes)
        self.est = PointNetEstimation(n_classes, n_heading_bin, ns)

    def forward(self, pts, one_hot, valid):
        """pts (B, N, 3); one_hot (B, C); valid (B, N) -> dict of the
        logits, the mask used, the centres and the heading / size
        scores and residuals."""
        logits = self.ins_seg(pts, one_hot, valid)
        fg = (logits[..., 1] > logits[..., 0]) & valid
        # every valid point where none is predicted foreground
        fg_eff = torch.where(fg.any(-1, keepdim=True), fg, valid)
        w = fg_eff.to(pts.dtype)
        denom = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
        centroid = (pts * w[..., None]).sum(-2) / denom
        obj_pts = (pts - centroid[..., None, :]) * w[..., None]
        delta = self.stn(obj_pts, one_hot, fg_eff)
        stage1_center = delta + centroid
        obj_pts = obj_pts - delta[..., None, :] * w[..., None]
        box = self.est(obj_pts, one_hot, fg_eff)
        nh, anchors = self.n_heading_bin, self.anchors.to(pts.dtype)
        ns = anchors.shape[0]
        heading_res_norm = box[..., 3 + nh:3 + 2 * nh]
        size_res_norm = box[..., 3 + 2 * nh + ns:].reshape(
            *box.shape[:-1], ns, 3)
        return {
            "logits": logits, "mask": fg_eff,
            "stage1_center": stage1_center,
            "center": box[..., :3] + stage1_center,
            "heading_scores": box[..., 3:3 + nh],
            "heading_res_norm": heading_res_norm,
            "heading_res": heading_res_norm * (math.pi / nh),
            "size_scores": box[..., 3 + 2 * nh:3 + 2 * nh + ns],
            "size_res_norm": size_res_norm,
            "size_res": size_res_norm * anchors,
        }


# ---------------------------------------------------------------- codec

def encode_heading(angle, n_bins: int):
    """angle -> (bin (int64), residual in [-pi/NH, pi/NH)); bins centred
    at k * 2pi / NH."""
    two_pi = 2 * math.pi
    a = torch.remainder(angle, two_pi)
    width = two_pi / n_bins
    cls = torch.remainder(torch.floor(a / width + 0.5), n_bins).long()
    res = torch.remainder(a - cls * width + math.pi, two_pi) - math.pi
    return cls, res


def decode_heading(heading_scores, heading_res, prerot=0.0):
    """The best bin's centre plus the softmax-weighted residual, plus the
    frustum's pre-rotation."""
    nh = heading_scores.shape[-1]
    cls = torch.argmax(heading_scores, -1).to(heading_res.dtype)
    soft = torch.softmax(heading_scores, -1)
    return cls * (2 * math.pi / nh) + (heading_res * soft).sum(-1) + prerot


def decode_size(size_scores, size_res, anchors):
    """The softmax-weighted mixture of anchor + residual."""
    soft = torch.softmax(size_scores, -1)[..., None]
    return (soft * (anchors + size_res)).sum(-2)


def _safe_norm(x):
    # a NaN-free gradient at 0 (the T-Net starts at exactly 0)
    return torch.sqrt((x ** 2).sum(-1) + 1e-12)


def _huber(x, delta):
    a = x.abs()
    return torch.where(a < delta, 0.5 * a ** 2 / delta, a - 0.5 * delta)


def _box_corners(center, heading, size):
    tmpl = torch.tensor(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
        dtype=center.dtype, device=center.device) / 2
    local = tmpl[None] * size[:, None, :]
    c, s = torch.cos(heading)[:, None], torch.sin(heading)[:, None]
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return torch.stack([x, y, local[..., 2]], -1) + center[:, None, :]


def frustum_pointnet_loss(out, targets, size_anchors, valid=None,
                          corner_w: float = 10.0, box_w: float = 1.0):
    """Segmentation CE + box_w * (centre huber(2) + stage-1 huber(1) +
    heading-bin CE + 20 heading-residual huber + size-cluster CE + 20
    size-residual huber + corner_w * the corner huber, the nearer of the
    box and its flip). targets: seg (B, N), center (B, 3), heading (B,),
    size_cls (B,), size (B, 3), optionally point_valid (B, N); `valid`
    (B,) masks padded queries. (total, parts)."""
    center = out["center"]
    anchors = torch.as_tensor(size_anchors, dtype=center.dtype,
                              device=center.device)
    nh = out["heading_scores"].shape[-1]
    ns = anchors.shape[0]
    b = center.shape[0]
    vmask = torch.ones(b, dtype=center.dtype, device=center.device) \
        if valid is None else valid.to(center.dtype)
    denom = torch.clamp(vmask.sum(), min=1.0)

    def mean_v(x):
        return (x * vmask).sum() / denom

    logp = torch.log_softmax(out["logits"], -1)
    seg_t = torch.clamp(targets["seg"].long(), min=0)
    pmask = targets.get("point_valid")
    if pmask is None:
        pmask = torch.ones(seg_t.shape, dtype=torch.bool,
                           device=seg_t.device)
    ce = -torch.gather(logp, -1, seg_t[..., None])[..., 0]
    pm = pmask.to(center.dtype) * vmask[:, None]
    seg_loss = (ce * pm).sum() / torch.clamp(pm.sum(), min=1.0)

    center_loss = mean_v(_huber(_safe_norm(center - targets["center"]), 2.0))
    stage1_loss = mean_v(_huber(_safe_norm(center - out["stage1_center"]),
                                1.0))
    h_cls, h_res = encode_heading(targets["heading"], nh)
    h_cls_loss = mean_v(-torch.gather(torch.log_softmax(
        out["heading_scores"], -1), -1, h_cls[..., None])[..., 0])
    h_res_pred = (out["heading_res_norm"]
                  * F.one_hot(h_cls, nh).to(center.dtype)).sum(-1)
    h_res_loss = mean_v(_huber(h_res_pred - h_res / (math.pi / nh), 1.0))
    s_cls = targets["size_cls"].long()
    s_cls_loss = mean_v(-torch.gather(torch.log_softmax(
        out["size_scores"], -1), -1, s_cls[..., None])[..., 0])
    s_res_pred = (out["size_res_norm"]
                  * F.one_hot(s_cls, ns).to(center.dtype)[..., None]).sum(-2)
    mean_size = anchors[s_cls]
    s_res_loss = mean_v(_huber(_safe_norm(
        (targets["size"] - mean_size) / mean_size - s_res_pred), 1.0))

    pred_heading = decode_heading(out["heading_scores"].detach(),
                                  out["heading_res"])
    pred_size = decode_size(out["size_scores"].detach(), out["size_res"],
                            anchors)
    c_pred = _box_corners(center, pred_heading, pred_size)
    c_gt = _box_corners(targets["center"], targets["heading"],
                        targets["size"])
    c_flip = _box_corners(targets["center"], targets["heading"] + math.pi,
                          targets["size"])
    d = torch.minimum(_safe_norm(c_pred - c_gt), _safe_norm(c_pred - c_flip))
    corner_loss = mean_v(_huber(d, 1.0).mean(-1))

    total = seg_loss + box_w * (
        center_loss + stage1_loss + h_cls_loss + s_cls_loss
        + 20.0 * h_res_loss + 20.0 * s_res_loss + corner_w * corner_loss)
    return total, {
        "seg_loss": seg_loss, "center_loss": center_loss,
        "stage1_loss": stage1_loss, "heading_cls_loss": h_cls_loss,
        "heading_res_loss": h_res_loss, "size_cls_loss": s_cls_loss,
        "size_res_loss": s_res_loss, "corner_loss": corner_loss,
    }
