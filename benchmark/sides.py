"""The system under test: the port's detector, built from the
configuration as the port's tools build it
(`findnpropagate_torch.models.build_network`) and driven through `forward`
+ `post_process` as `tools/test.py`'s evaluation loop calls it. Its
stand-in, the control, is the adapter's (detectors/<detector>.py).

`infer(batch)` runs one batch on the device and returns the detections;
with `capture=True` it also returns what the comparison reads, taken from
the timed path itself by the adapter's hooks.
"""

from __future__ import annotations

import types


def grid_size(data):
    pcr, vs = data["POINT_CLOUD_RANGE"], data["VOXEL_SIZE"]
    return [int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3)]


def model_section(config):
    """The configuration's MODEL keys (the file's upper-case keys other
    than CLASS_NAMES and DATA)."""
    return {k: v for k, v in config.items()
            if k.isupper() and k not in ("CLASS_NAMES", "DATA")}


class PortSide:
    """The port's detector in eval mode, loaded with `state`; `adapter` the
    configuration's detector adapter."""

    name = "port"
    warm_up = True

    def __init__(self, config, state, device, adapter):
        from findnpropagate_torch.config import EDict
        from findnpropagate_torch.models import build_network

        data = config["DATA"]
        ds = types.SimpleNamespace(
            class_names=list(config["CLASS_NAMES"]),
            grid_size=grid_size(data),
            voxel_size=data["VOXEL_SIZE"],
            point_cloud_range=data["POINT_CLOUD_RANGE"],
            num_point_features=len(data["POINT_FEATURES"]),
            max_voxels=data["MAX_VOXELS"],
            max_points_per_voxel=data["MAX_POINTS_PER_VOXEL"])
        self.det = build_network(EDict(model_section(config)),
                                 len(config["CLASS_NAMES"]), ds,
                                 device=device)
        self.det.load_state_dict(state, strict=True)
        self.det.eval()
        self.adapter = adapter
        self._capture = adapter.Capture(self.det)
        self.spans = None

    def trace(self):
        """Record the spans of trace.py on every later batch."""
        from .trace import Spans

        self.spans = Spans(self.det)
        return self.spans

    def infer(self, batch, capture=False):
        self._capture.start(capture)
        try:
            out = self.det(batch)
            if self.spans is not None:
                self.spans.mark("decode", "pre")
            dets = self.det.post_process(out, **self.adapter.POST_PROCESS)
            if self.spans is not None:
                self.spans.mark("decode", "post")
        finally:
            got = self._capture.stop()
        return dets, (self.adapter.capture(got, dets) if capture else None)

    def close(self):
        self._capture.close()
        if self.spans is not None:
            self.spans.close()
