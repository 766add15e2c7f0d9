"""Frozen copy of the port's findnpropagate_torch/models/model_utils/transformer.py, kept under the
benchmark so that a change to the program cannot move the yardstick.

Transformer decoder components for TransFusion — port of
findnpropagate_tpu/models/model_utils/transformer.py:18-68.

Layout (B, N, C) throughout. Attention is written out as matmul + softmax,
as flax's MultiHeadDotProductAttention computes it (queries scaled by
1/sqrt(head_dim), softmax over keys in float32). In training, dropout
falls where the reference puts it — on the attention weights, on each
attention output, inside the FFN and on its output — with masks drawn
from an explicit torch.Generator (the two frameworks' random bits differ,
so parity tests run at rate 0). LayerNorm eps is flax's default 1e-6.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .blocks import BN_EPS, BatchNorm1d


def dropout(x, rate: float, training: bool, generator=None):
    """Inverted dropout with the mask drawn from `generator` (on x's
    device); the identity at eval or rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class MultiHeadAttention(nn.Module):
    """Separate query/key/value/out projections, flax's parameter split."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, generator=None, mask=None):
        """mask: bool, broadcast to (B, H, Nq, Nk), False where a query
        may not attend (its logit the dtype's lowest value, as flax sets
        it: a query with no key allowed attends evenly)."""
        b, nq, _ = q.shape
        nk = k.shape[1]
        h, dh = self.num_heads, self.head_dim
        q = self.query(q).view(b, nq, h, dh).transpose(1, 2)
        k = self.key(k).view(b, nk, h, dh).transpose(1, 2)
        v = self.value(v).view(b, nk, h, dh).transpose(1, 2)
        logits = (q / math.sqrt(dh)) @ k.transpose(-1, -2)    # (B,H,Nq,Nk)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        attn = dropout(attn, self.dropout, self.training, generator)
        x = (attn @ v).transpose(1, 2).reshape(b, nq, h * dh)
        return self.out(x)


class PositionEmbeddingLearned(nn.Module):
    """xy (B, N, 2) -> Dense, BatchNorm, ReLU, Dense -> (B, N, D)."""

    def __init__(self, num_pos_feats: int, in_dim: int = 2):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, num_pos_feats)
        self.BatchNorm_0 = BatchNorm1d(num_pos_feats, eps=BN_EPS)
        self.Dense_1 = nn.Linear(num_pos_feats, num_pos_feats)

    def forward(self, xy):
        x = self.Dense_0(xy)
        x = self.BatchNorm_0(x.transpose(1, 2)).transpose(1, 2)
        return self.Dense_1(torch.relu(x))


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention and FFN, each with a residual and a
    post-norm; with `cross_only` the self-attention and its norm are left
    out (and hold no parameters), as in the reference."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, cross_only: bool = False):
        super().__init__()
        self.dropout = dropout
        self.cross_only = cross_only
        self.self_posembed = PositionEmbeddingLearned(d_model)
        self.cross_posembed = PositionEmbeddingLearned(d_model)
        if not cross_only:
            self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
            self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, query, key, query_pos, key_pos, generator=None):
        """query (B, P, C); key (B, K, C); query_pos (B, P, 2);
        key_pos (B, K, 2)."""
        def drop(x):
            return dropout(x, self.dropout, self.training, generator)

        q_embed = self.self_posembed(query_pos)
        k_embed = self.cross_posembed(key_pos)
        if not self.cross_only:
            qkv = query + q_embed
            query = self.norm1(query + drop(
                self.self_attn(qkv, qkv, qkv, generator)))
        kk = key + k_embed
        query = self.norm2(query + drop(
            self.cross_attn(query + q_embed, kk, kk, generator)))
        ffn = self.linear2(drop(torch.relu(self.linear1(query))))
        return self.norm3(query + drop(ffn))
