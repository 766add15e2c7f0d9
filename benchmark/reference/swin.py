"""Frozen copy of the port's findnpropagate_torch/models/backbones_image/swin.py, kept under the
benchmark so that a change to the program cannot move the yardstick.

SwinTransformer image backbone — port of
findnpropagate_tpu/models/backbones_image/swin.py (`window_partition` :23,
`window_reverse` :30, `_rel_pos_index` :36, `WindowAttention` :44,
`SwinBlock` :79, `PatchMerging` :132, `SwinTransformer` :151).

Patch embedding (a PATCH_SIZE conv with flax's SAME padding), stages of
(shifted-)window self-attention blocks with a relative position bias, patch
merging between stages and a LayerNorm on each OUT_INDICES stage. Tokens
run channels last (B, L, C) as in the reference; the window is cut to the
map where the map is smaller (and the shift dropped; the bias tables are
sized from the image size given at construction), the map is padded at
the bottom and right to a multiple of the window (256 / 4 = 64 rows are not
a multiple of 7), and a shifted block rolls by -shift with the reference's
-100 attention mask between the wrapped regions. PatchMerging concatenates
the 2x2 neighbours in the reference's order: (0, 0), (1, 0), (0, 1),
(1, 1) as (row, column). LayerNorm eps 1e-6 and the tanh GELU are flax's
defaults. ``image_features`` holds the chosen stages as NCHW maps
(B*N, C, h, w).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import same_pad

LN_EPS = 1e-6      # flax nn.LayerNorm's


def window_partition(x, ws):
    """(B, H, W, C) -> (B*nH*nW, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(wins, ws, h, w):
    b = wins.shape[0] // (h // ws * w // ws)
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _rel_pos_index(ws):
    """(ws^2, ws^2) int: the bias-table row of each (query, key) pair."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(hp, wp, ws, shift):
    """(nW, ws^2, ws^2) float32: -100 between tokens of different regions
    of a rolled map, 0 within one."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss, :] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), ws).reshape(-1, ws * ws)
    return torch.where(mw[:, None, :] != mw[:, :, None],
                       torch.tensor(-100.0), torch.tensor(0.0))


class WindowAttention(nn.Module):
    FLAX_LEAVES = ("relative_position_bias_table",)

    def __init__(self, dim, num_heads, window_size):
        super().__init__()
        self.dim, self.num_heads, self.ws = dim, num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("rel_index", torch.from_numpy(
            _rel_pos_index(window_size).reshape(-1)), persistent=False)

    def forward(self, x, mask=None):
        """x (nW*B, N, C); mask (nW, N, N) or None."""
        b_, n, c = x.shape
        hd = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = q * (hd ** -0.5)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
        bias = self.relative_position_bias_table[self.rel_index].reshape(
            n, n, self.num_heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, self.num_heads, n, n)
                    + mask[None, :, None]).reshape(b_, self.num_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift, mlp_ratio=4.0,
                 map_hw=None):
        """`map_hw`: the block's map size where it is known; a map smaller
        than the window cuts the window (and the bias table) to it."""
        super().__init__()
        self.window_size, self.shift = window_size, shift
        ws = min(window_size, *map_hw) if map_hw else window_size
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = nn.Linear(dim, int(dim * mlp_ratio))
        self.Dense_1 = nn.Linear(int(dim * mlp_ratio), dim)
        self._masks = {}

    def _mask(self, hp, wp, ws, shift, device):
        key = (hp, wp, ws, shift, str(device))
        if key not in self._masks:
            self._masks[key] = _shift_mask(hp, wp, ws, shift).to(device)
        return self._masks[key]

    def forward(self, x, hw):
        h, w = hw
        b, l, c = x.shape
        ws = min(self.window_size, h, w)
        if ws != self.attn.ws:
            raise ValueError(f"a {h}x{w} map takes windows of {ws}; the "
                             f"block was built for {self.attn.ws} (give "
                             "SwinTransformer the image size)")
        shift = self.shift if ws < min(h, w) else 0
        shortcut = x
        y = self.LayerNorm_0(x).reshape(b, h, w, c)
        pad_b, pad_r = (-h) % ws, (-w) % ws
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, ws, shift, x.device)
        wins = window_partition(y, ws).reshape(-1, ws * ws, c)
        wins = self.attn(wins, mask)
        y = window_reverse(wins.reshape(-1, ws, ws, c), ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = shortcut + y[:, :h, :w].reshape(b, l, c)
        y = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)),
                                approximate="tanh"))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, hw):
        h, w = hw
        b, _, c = x.shape
        y = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            y = F.pad(y, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                       y[:, 0::2, 1::2], y[:, 1::2, 1::2]], dim=-1)
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        y = self.LayerNorm_0(y.reshape(b, h2 * w2, 4 * c))
        return self.Dense_0(y), (h2, w2)


class SwinTransformer(nn.Module):
    """`image_size` (H, W): where a stage's map is smaller than the window,
    its blocks' windows and bias tables are cut to it, as the reference's
    flax modules size them at init; without it every map must hold a
    window (BEVFusion's 256 x 704 images do)."""

    def __init__(self, model_cfg, image_size=None):
        super().__init__()
        cfg = model_cfg
        embed = int(cfg.get("EMBED_DIMS", 96))
        self.depths = [int(d) for d in cfg.get("DEPTHS", (2, 2, 6, 2))]
        heads = [int(h) for h in cfg.get("NUM_HEADS", (3, 6, 12, 24))]
        ws = int(cfg.get("WINDOW_SIZE", 7))
        self.patch = int(cfg.get("PATCH_SIZE", 4))
        self.out_indices = tuple(int(i) for i in cfg.get("OUT_INDICES",
                                                         (1, 2, 3)))
        self.patch_embed = nn.Conv2d(3, embed, self.patch, self.patch)
        self.LayerNorm_0 = nn.LayerNorm(embed, eps=LN_EPS)
        dim = embed
        self.out_channels = []
        hw = None if image_size is None else tuple(
            -(-int(n) // self.patch) for n in image_size)
        for si, (depth, nh) in enumerate(zip(self.depths, heads)):
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", SwinBlock(
                    dim, nh, ws, shift=0 if bi % 2 == 0 else ws // 2,
                    map_hw=hw))
            if si in self.out_indices:
                self.add_module(f"out_norm{si}", nn.LayerNorm(dim,
                                                              eps=LN_EPS))
                self.out_channels.append(dim)
            if si < len(self.depths) - 1:
                self.add_module(f"merge{si}", PatchMerging(dim))
                dim *= 2
                hw = hw and ((hw[0] + 1) // 2, (hw[1] + 1) // 2)

    def forward(self, batch):
        x = batch["camera_imgs"].float()
        x = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
        x = self.patch_embed(same_pad(x, self.patch, self.patch))
        b, c, h, w = x.shape
        x = self.LayerNorm_0(x.flatten(2).transpose(1, 2))
        hw = (h, w)
        outs = []
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                x = getattr(self, f"stage{si}_block{bi}")(x, hw)
            if si in self.out_indices:
                y = getattr(self, f"out_norm{si}")(x)
                outs.append(y.reshape(b, hw[0], hw[1], -1).permute(
                    0, 3, 1, 2).contiguous())
            if si < len(self.depths) - 1:
                x, hw = getattr(self, f"merge{si}")(x, hw)
        batch["image_features"] = outs
        return batch
