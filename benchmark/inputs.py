"""The scenes of a traffic mix in pinned host memory, batched.

A pool of scenes made from the mix's own scene seed and batched in its
order, so that every run seed serves the same batches; the run's seed
orders the batches in the window's cycle and draws the images on the
device. (With the batches drawn by the run's seed, their make-up moved the
window's work by 2-4 % from seed to seed.)
"""

from __future__ import annotations

import numpy as np
import torch

from . import scenes
from .reference.model import CAMERA_KEYS


class Traffic:
    """The mix's batches: points (B, MAX_POINTS, features) with their mask,
    and where the configuration has cameras, the images and the rig."""

    def __init__(self, config, traffic, seed, device):
        data = config["DATA"]
        b, pool = int(traffic["batch"]), int(traffic["pool"])
        if pool % b:
            raise ValueError(f"pool {pool} is not a multiple of batch {b}")
        rng = np.random.default_rng(seed)
        order = np.concatenate([np.arange(k * b, (k + 1) * b) for k in
                                rng.permutation(pool // b)])
        pts = [scenes.scene(int(traffic["scene_seed"]) + int(i),
                            config["CLASS_NAMES"], data["POINT_CLOUD_RANGE"],
                            int(traffic["objects"]), int(traffic["points"]))[0]
               for i in order]
        cap = int(data["MAX_POINTS"])
        pin = device.type == "cuda"
        self.batches = []
        cam = data.get("CAMERA")
        imgs = None
        if cam:
            h, w = cam["IMAGE_SIZE"]
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))
            imgs = torch.rand((pool, int(cam["NUM"]), h, w, 3),
                              generator=gen, device=device).cpu()
            rig = [torch.from_numpy(m) for m in
                   scenes.camera_rig(int(cam["NUM"]), cam["IMAGE_SIZE"])]
        for k in range(pool // b):
            points = torch.zeros((b, cap, len(data["POINT_FEATURES"])))
            mask = torch.zeros((b, cap), dtype=torch.bool)
            for j, p in enumerate(pts[k * b:(k + 1) * b]):
                p = p[:cap]
                points[j, :len(p)] = torch.from_numpy(p)
                mask[j, :len(p)] = True
            hb = {"points": points, "points_mask": mask}
            if cam:
                hb["camera_imgs"] = imgs[k * b:(k + 1) * b].clone()
                for key, m in zip(CAMERA_KEYS[1:], rig):
                    hb[key] = m[None].expand(b, *m.shape).clone()
            if pin:
                hb = {key: v.pin_memory() for key, v in hb.items()}
            self.batches.append(hb)
        self.scenes_per_batch = b
        self.device = device

    def to_device(self, i):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in self.batches[i % len(self.batches)].items()}
