"""Fixed-size final detections — port of `Detections`,
findnpropagate_tpu/models/post_processing.py:22-31."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    boxes: torch.Tensor   # (B, D, 7+C)
    scores: torch.Tensor  # (B, D)
    labels: torch.Tensor  # (B, D) int32, 1-indexed; 0 for empty slots
    count: torch.Tensor   # (B,) int32


def top_k_lower_index_first(x, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    broken by the lower index first — the order `jax.lax.top_k` gives.
    `torch.topk` leaves the order of ties unspecified, so this is a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
