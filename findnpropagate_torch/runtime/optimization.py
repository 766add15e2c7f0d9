"""Optimizer and LR schedule — port of
findnpropagate_tpu/runtime/optimization.py:14-53.

The reference builds optax transformations; here the same arithmetic is
written out over torch.optim:

  * `build_lr_schedule`: ``adam_onecycle`` is optax's
    `cosine_onecycle_schedule` — cosine from LR/DIV_FACTOR up to LR over
    PCT_START of the steps, then cosine down to LR/1e4 — which is not
    torch's OneCycleLR; otherwise piecewise-constant decay at
    DECAY_STEP_LIST (fractions of the run) or a constant;
  * gradient clipping is optax's `clip_by_global_norm`: gradients are left
    alone below GRAD_NORM_CLIP and scaled by clip / norm above it (torch's
    clip_grad_norm_ divides by norm + 1e-6);
  * ``adam`` / ``adam_onecycle`` use decoupled weight decay (AdamW) only
    when WEIGHT_DECAY > 0, over every parameter; ``sgd`` uses MOMENTUM.
    MOMS and BETAS are not read, as in the reference.

The schedule is evaluated at the number of updates already made, so the
first step runs at ``schedule(0)``.
"""

from __future__ import annotations

import math

import torch


def _cosine(start, end, pct):
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))


def build_lr_schedule(opt_cfg, total_steps: int):
    """step -> learning rate (python floats)."""
    lr = float(opt_cfg["LR"])
    name = opt_cfg.get("OPTIMIZER", "adam_onecycle")
    if name == "adam_onecycle":
        pct = float(opt_cfg.get("PCT_START", 0.4))
        div = float(opt_cfg.get("DIV_FACTOR", 10))
        steps = max(total_steps, 1)
        bounds = [0, int(pct * steps), int(steps)]
        values = [lr / div, lr, lr / 1e4]

        def onecycle(count):
            if count >= bounds[2]:
                return values[2]
            i = 0 if count < bounds[1] else 1
            pct_i = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            return _cosine(values[i], values[i + 1], pct_i)

        return onecycle
    # two entries that round to one step decay once, as a dict of them would
    decay_steps = sorted({int(s * total_steps)
                          for s in opt_cfg.get("DECAY_STEP_LIST", [])})
    rate = float(opt_cfg.get("LR_DECAY", 0.1))
    return lambda count: lr * rate ** sum(count >= s for s in decay_steps)


class Optimizer:
    """clip-by-global-norm, then the base optimizer at the scheduled rate.
    `step()` reads the parameters' .grad, returns the gradient norm before
    clipping (a 0-d tensor), and counts the update."""

    def __init__(self, base, schedule, clip: float):
        self.base, self.schedule, self.clip = base, schedule, float(clip)
        self.count = 0

    def params(self):
        return [p for g in self.base.param_groups for p in g["params"]]

    def zero_grad(self):
        self.base.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params() if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        factor = torch.where(norm < self.clip, torch.ones_like(norm),
                             self.clip / norm)
        for g in grads:
            g.mul_(factor.to(g.dtype))
        lr = self.schedule(self.count)
        for group in self.base.param_groups:
            group["lr"] = lr
        self.base.step()
        self.count += 1
        return norm

    def state_dict(self):
        return {"count": self.count, "base": self.base.state_dict()}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.base.load_state_dict(state["base"])


def build_optimizer(params, opt_cfg, total_steps: int):
    """params: the parameters to train (``model.parameters()``). Returns
    (Optimizer, schedule)."""
    name = opt_cfg.get("OPTIMIZER", "adam_onecycle")
    schedule = build_lr_schedule(opt_cfg, total_steps)
    wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0))
    clip = float(opt_cfg.get("GRAD_NORM_CLIP", 10.0))
    params = list(params)
    lr0 = schedule(0)       # overwritten from the schedule at every step
    if name in ("adam", "adam_onecycle"):
        if wd > 0:
            base = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=wd)
        else:
            base = torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999),
                                    eps=1e-8)
    elif name == "sgd":
        base = torch.optim.SGD(params, lr=lr0,
                               momentum=float(opt_cfg.get("MOMENTUM", 0.9)))
    else:
        raise KeyError(f"unknown optimizer {name}")
    return Optimizer(base, schedule, clip), schedule
