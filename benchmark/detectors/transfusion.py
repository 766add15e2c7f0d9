"""The adapter of the detectors with a TransFusion head (TransFusion-L, and
BEVFusion with its camera branch and ConvFuser): a configuration names it
by `"detector": "transfusion"`.

An adapter gives the harness, for its detectors:
  reference(config, state, device)  the plain reference (reference/),
        laid out on the meta device where `state` is None (the weights'
        layout);
  Capture(det)        hooks on the port's detector that keep the timed
        path's own intermediate results of a checked batch;
  capture(got, dets)  what the comparison reads, from those results;
  Control(...)        the reference at the control's precision in the
        port's place;
  compare_batch(ref, batch, cap, scenes)  the numbers of one checked batch;
  failed(dets)        the scans of a batch whose detections are not finite;
  work(ref, inputs, device, n_batches, config)  the counted work of a
        traced window;
  POST_PROCESS        the keyword arguments of the port's `post_process`.

What is compared (each number the worst over the checked scenes, drawn
from the seed among the batch's; actives over every scene of the batch):

  actives      |port - reference| of the active voxels of sparse levels
               1-4, summed over the batch (exact);
  bev_err      the BEV map after HeightCompression, ||P - R|| / ||R||;
  camera_err   the camera branch's BEV features (BEVFusion), likewise;
  heatmap_err  the head's dense class heatmap (logits), likewise;
  pick_miss    the side's NUM_PROPOSALS query picks (class, cell) against
               the reference's selection (3 x 3 local maxima of the sigmoid
               heatmap, kernel 1 for the small classes, top NUM_PROPOSALS,
               ties to the lower index) run on the side's own dense
               heatmap: the picks that differ (exact);
  query_err    the head's per-query outputs with the reference's decoder run
               on the side's picks: ||P - R|| / ||R|| over all queries and
               outputs (centre offset, height, size, rotation, velocity,
               class logits);
  decode_err   the detections of the whole batch against the reference's
               decode of the side's own per-query outputs: the largest
               difference of a box or score, 1e9 where a label or the count
               differs (exact).

The reference follows the side's own state at two stages, each judged
exactly and its input judged on its own: the picks from the side's
heatmap (heatmap_err), the decode from its per-query outputs (query_err).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.check import rel
from benchmark.reference.model import CAMERA_KEYS, MAX_DET, ReferenceDetector
from benchmark.reference.precision import (CONTROL_DENSE, exact_float32,
                                           lower_dense_operands)
from benchmark.reference.transfusion_head import top_k_lower_index_first
from benchmark.sides import model_section
from benchmark.work import WorkCounter, sparse_work

QUERY_OUTPUTS = ("center", "height", "dim", "rot", "vel", "heatmap")
MISMATCH = 1e9
POST_PROCESS = {"max_det": MAX_DET}


def reference(config, state=None, device=None):
    """The reference detector of `config`, loaded with `state` on `device`
    (in eval mode); without `state`, its layout on the meta device."""
    args = (model_section(config), config["DATA"], config["CLASS_NAMES"])
    if state is None:
        with torch.device("meta"):
            return ReferenceDetector(*args)
    ref = ReferenceDetector(*args).to(device)
    ref.load_state_dict(state, strict=True)
    return ref.eval()


# ---- the port's timed path -------------------------------------------------


def query_cells(query_pos, width):
    """The head's query positions ((x + 0.5, y + 0.5) of a BEV cell) ->
    the cells' flat indices y * width + x."""
    xy = torch.floor(query_pos).long()
    return xy[..., 1] * width + xy[..., 0]


class Capture:
    """Forward hooks on the port's detector that keep the timed path's own
    intermediate results while on."""

    def __init__(self, det):
        self.on, self.got, self.handles = False, {}, []

        def keep(name, fn):
            def hook(_mod, args, out=None):
                if self.on:
                    self.got[name] = fn(args, out)
            return hook

        self.handles.append(det.backbone_3d.register_forward_hook(keep(
            "actives", lambda a, o: o["sparse_active_counts"].clone())))
        self.handles.append(det.map_to_bev.register_forward_hook(keep(
            "bev", lambda a, o: o["spatial_features"].clone())))
        if det.vtransform is not None:
            self.handles.append(det.vtransform.register_forward_hook(keep(
                "camera", lambda a, o: o["spatial_features_img"].clone())))
        self.handles.append(det.dense_head.decoder.register_forward_pre_hook(
            keep("query_pos", lambda a, o: a[2].clone())))
        self.handles.append(det.dense_head.register_forward_hook(keep(
            "res", lambda a, o: {k: v.clone() for k, v in
                                 o["transfusion_preds"].items()})))

    def start(self, on):
        self.on, self.got = on, {}

    def stop(self):
        self.on = False
        return self.got

    def close(self):
        for h in self.handles:
            h.remove()


def capture(got, dets):
    """What the comparison reads of a batch the port ran."""
    res = got["res"]
    width = res["dense_heatmap"].shape[-1]
    return {"actives": got["actives"], "bev": got["bev"],
            "camera": got.get("camera"), "res": res,
            "q_class": res["query_labels"].long(),
            "q_index": query_cells(got["query_pos"], width), "dets": dets}


def failed(dets):
    """The scans of a batch (detections on the host) with a box or score
    that is not finite."""
    boxes, scores = dets[0], dets[1]
    return int(((~torch.isfinite(boxes).all(-1).all(-1))
                | (~torch.isfinite(scores).all(-1))).sum())


class Control:
    """The reference at the control's precision in the port's place, scene
    by scene: fp8 operands in the 3D convolutions, CONTROL_DENSE in the
    dense layers (reference/precision.py)."""

    name = "control"
    warm_up = False     # nothing is built or compiled

    def __init__(self, config, state, device, fmt3d="fp8"):
        self.ref = reference(config, state, device)
        self.fmt3d = fmt3d
        self.handles = lower_dense_operands(self.ref, CONTROL_DENSE)

    def trace(self):
        return None

    @torch.no_grad()
    def infer(self, batch, capture=False):
        outs = []
        for b in range(batch["points"].shape[0]):
            pts = batch["points"][b][batch["points_mask"][b]]
            cams = {k: batch[k][b] for k in CAMERA_KEYS} \
                if self.ref.has_camera else None
            outs.append(self.ref.scene(pts, cams, fmt3d=self.fmt3d))
        dets = type(outs[0]["dets"])(*(torch.cat(
            [o["dets"][i] for o in outs]) for i in range(4)))
        if not capture:
            return dets, None
        res = {k: torch.cat([o["res"][k] for o in outs])
               for k in outs[0]["res"]}
        cap = {"actives": torch.tensor(outs[0]["actives"]).new_tensor(
                   [sum(o["actives"][i] for o in outs) for i in range(4)]),
               "bev": torch.cat([o["bev"] for o in outs]),
               "camera": torch.cat([o["camera"] for o in outs])
               if self.ref.has_camera else None,
               "res": res, "q_class": res["query_labels"].long(),
               "q_index": res["query_index"].long(), "dets": dets}
        return dets, cap

    def close(self):
        for h in self.handles:
            h.remove()


# ---- the comparison --------------------------------------------------------


def pick_miss(head, dense_heatmap, q_class, q_index):
    """The side's picks of one scene not in the reference's selection on
    the side's own heatmap (C, H, W)."""
    hm = torch.sigmoid(dense_heatmap.float())
    c, h, w = hm.shape
    pad = head.nms_kernel_size // 2
    lmax = F.pad(F.max_pool2d(hm[None], head.nms_kernel_size, stride=1),
                 (pad, pad, pad, pad))[0]
    for ci in head._flat_kernel1_classes():
        lmax[ci] = hm[ci]
    sup = hm * (hm == lmax)
    _, top = top_k_lower_index_first(sup.reshape(1, -1), head.num_proposals)
    mine = q_class * (h * w) + q_index
    return float((top[0] != mine).sum())


def query_errs(side_res, ref_res, b, q_pos):
    """(over all queries, worst single query) relative error of the
    scene's per-query outputs."""
    parts_p, parts_r = [], []
    for k in QUERY_OUTPUTS:
        if k not in ref_res:
            continue
        p, r = side_res[k][b].float(), ref_res[k][0].float()
        if k == "center":
            p, r = p - q_pos, r - q_pos
        parts_p.append(p)
        parts_r.append(r)
    p, r = torch.cat(parts_p, -1), torch.cat(parts_r, -1)
    per = (p - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    return rel(p, r), float(per.max())


def decode_err(ref, side_res, side_dets):
    """The side's detections against the reference's decode of its own
    per-query outputs."""
    want = ref.decode(side_res)
    if not (torch.equal(want.labels.to(side_dets.labels.dtype),
                        side_dets.labels)
            and torch.equal(want.count.to(side_dets.count.dtype),
                            side_dets.count)):
        return MISMATCH
    return max(float((want.boxes - side_dets.boxes).abs().max()),
               float((want.scores - side_dets.scores).abs().max()))


@torch.no_grad()
def compare_batch(ref, batch, cap, scenes):
    """The numbers of one checked batch: `batch` the device batch the side
    ran, `cap` what it produced, `scenes` the batch's scenes compared."""
    # query_err_max, the worst single query's error, is a reading only
    out = {"actives": 0.0, "bev_err": 0.0, "camera_err": 0.0,
           "heatmap_err": 0.0, "pick_miss": 0.0, "query_err": 0.0,
           "decode_err": 0.0, "query_err_max": 0.0}
    if not ref.has_camera:
        del out["camera_err"]
    res = cap["res"]
    head = ref.dense_head
    totals = [0, 0, 0, 0]
    with exact_float32():
        for b in range(batch["points"].shape[0]):
            pts = batch["points"][b][batch["points_mask"][b]]
            totals = [t + c for t, c in zip(totals, ref.actives(pts))]
        for b in scenes:
            pts = batch["points"][b][batch["points_mask"][b]]
            bev, _, _, _ = ref.lidar(pts)
            out["bev_err"] = max(out["bev_err"], rel(cap["bev"][b], bev[0]))
            cam = None
            if ref.has_camera:
                cam = ref.camera(pts, {k: batch[k][b] for k in CAMERA_KEYS})
                out["camera_err"] = max(out["camera_err"],
                                        rel(cap["camera"][b], cam[0]))
            queries = (cap["q_class"][b:b + 1], cap["q_index"][b:b + 1])
            ref_res = ref.head(bev, cam, queries)
            out["heatmap_err"] = max(out["heatmap_err"], rel(
                res["dense_heatmap"][b], ref_res["dense_heatmap"][0]))
            out["pick_miss"] = max(out["pick_miss"], pick_miss(
                head, res["dense_heatmap"][b], cap["q_class"][b],
                cap["q_index"][b]))
            w = ref_res["dense_heatmap"].shape[-1]
            q_pos = torch.stack([cap["q_index"][b] % w,
                                 cap["q_index"][b] // w], -1).float() + 0.5
            err, worst = query_errs(res, ref_res, b, q_pos)
            out["query_err"] = max(out["query_err"], err)
            out["query_err_max"] = max(out["query_err_max"], worst)
    side = [int(v) for v in cap["actives"].tolist()]
    out["actives"] = float(max(abs(s - t) for s, t in zip(side, totals)))
    out["decode_err"] = decode_err(ref, res, cap["dets"])
    return out


# ---- the counted work of a traced window ----------------------------------


def work(ref, inputs, device, n_batches, config):
    """The counted work of the window's batches: each pool batch's sparse
    convolutions from the reference's rulebook, the dense layers of one
    scene by WorkCounter (the same for every scene)."""
    dense_from = int(config["BACKBONE_3D"].get("DENSE_FROM_LEVEL", 1))
    per_batch = []
    with torch.no_grad():
        for hb in inputs.batches:
            flops = bound = 0.0
            for b in range(hb["points"].shape[0]):
                pts = hb["points"][b][hb["points_mask"][b]].to(device)
                _, _, rulebook, _ = ref.lidar(pts)
                f, s = sparse_work(rulebook, dense_from)
                flops, bound = flops + f, bound + s
            per_batch.append((flops, bound))
        hb = inputs.batches[0]
        pts = hb["points"][0][hb["points_mask"][0]].to(device)
        bev, _, _, _ = ref.lidar(pts)
        counter = WorkCounter()
        with counter:
            cam = None
            if ref.has_camera:
                counter.layer = "camera"
                cam = ref.camera(pts, {k: hb[k][0].to(device)
                                       for k in CAMERA_KEYS})
            counter.layer = "bev_head"
            res = ref.head(bev, cam)
            counter.layer = "decode"
            ref.decode(res)
    nb = len(per_batch)
    scans = n_batches * inputs.scenes_per_batch
    sparse_flops = sum(per_batch[i % nb][0] for i in range(n_batches))
    sparse_bound = sum(per_batch[i % nb][1] for i in range(n_batches))
    return {"backbone3d_bound_ms": 1e3 * sparse_bound,
            "camera_bound_ms": 1e3 * scans * counter.bound.get("camera",
                                                               0.0),
            "flops": sparse_flops + scans * sum(counter.flops.values())}
