"""MPPNet building blocks — port of
findnpropagate_tpu/models/model_utils/mppnet_utils.py (`MLPStack` :24,
`FFNBlock` :38, `SpatialMixerBlock` :58, `MPPNetEncoderLayer` :96,
`MPPNetTransformer` :159, `SeqBoxPointNet` :221).

The groups of the grouped transformer live on their own axis (B, NG, G,
D), as in the reference. Submodules carry the flax names (``fc0``,
``norm_tgt``, ``mixer_x``, ``self_attn``, ``cross_attn_{i}``,
``ffn_{i}``, ``layer{i}``, the transformer's ``token`` leaf, ...), so
utils/weights.py maps a flax tree onto them. LayerNorm eps is flax's
1e-6; dropout masks come from an explicit torch.Generator (parity runs at
rate 0; the 16-frame fusion's ``fusion_norm`` keeps flax's default rate
0.1 whatever the config says, as in the reference).
"""

from __future__ import annotations

import torch
from torch import nn

from .transformer import MultiHeadAttention, dropout

LN_EPS = 1e-6


class MLPStack(nn.Module):
    """num_layers Linear layers, ReLU between them (``fc{i}``)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.num_layers - 1}")(x)


class FFNBlock(nn.Module):
    """tgt + dropout(branch) -> LayerNorm -> residual FFN -> LayerNorm."""

    def __init__(self, d_model: int, dim_feedforward: int = 512,
                 rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.norm_tgt = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm_out = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, tgt_input, generator=None):
        def drop(x):
            return dropout(x, self.rate, self.training, generator)

        tgt = self.norm_tgt(tgt + drop(tgt_input))
        ff = self.linear2(drop(torch.relu(self.linear1(tgt))))
        return self.norm_out(tgt + drop(ff))


class SpatialMixerBlock(nn.Module):
    """Axis-wise MLP mixing over the grid^3 proxies (x-major layout): an
    MLP along gx, gy and gz in turn, each with a residual and a LayerNorm
    over the channels, then a channel FFN."""

    def __init__(self, hidden_dim: int, grid_size: int, channels: int,
                 rate: float = 0.0):
        super().__init__()
        self.grid_size, self.channels, self.rate = grid_size, channels, rate
        for name in ("mixer_x", "mixer_y", "mixer_z"):
            setattr(self, name, MLPStack(grid_size, hidden_dim, grid_size, 3))
            setattr(self, f"norm_{name}", nn.LayerNorm(channels, eps=LN_EPS))
        self.ffn1 = nn.Linear(channels, 2 * channels)
        self.ffn2 = nn.Linear(2 * channels, channels)
        self.norm_channel = nn.LayerNorm(channels, eps=LN_EPS)

    def forward(self, src, generator=None):
        g, c = self.grid_size, self.channels
        lead = src.shape[:-2]
        x = src.reshape(*lead, g, g, g, c)
        for name, axis in (("mixer_x", -4), ("mixer_y", -3),
                           ("mixer_z", -2)):
            moved = x.movedim(axis, -1)
            mixed = getattr(self, name)(moved).movedim(-1, axis) + x
            x = getattr(self, f"norm_{name}")(mixed)
        x = x.reshape(*lead, g * g * g, c)
        ff = dropout(torch.relu(self.ffn1(x)), self.rate, self.training,
                     generator)
        return self.norm_channel(x + self.ffn2(ff))


class MPPNetEncoderLayer(nn.Module):
    """One grouped encoder layer. token (B, NG, D), feats (B, NG, G, D):
    intra-group mixing, each group token attending over its own group,
    and (all but the last layer) the groups fused and cross-attended by
    each group with its own weights."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 num_groups: int, grid_size: int, mixer_hidden: int,
                 rate: float = 0.1, last_layer: bool = False):
        super().__init__()
        self.rate, self.last_layer = rate, last_layer
        self.num_groups = num_groups
        self.mlp_mixer_3d = SpatialMixerBlock(mixer_hidden, grid_size,
                                              d_model)
        self.self_attn = MultiHeadAttention(d_model, nhead, rate)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        if not last_layer:
            self.fusion_all_groups = MLPStack(num_groups * d_model, d_model,
                                              d_model, 4)
            for i in range(num_groups):
                setattr(self, f"cross_attn_{i}",
                        MultiHeadAttention(d_model, nhead, rate))
                setattr(self, f"ffn_{i}",
                        FFNBlock(d_model, dim_feedforward, rate))

    def forward(self, token, feats, pos, generator=None):
        def drop(x):
            return dropout(x, self.rate, self.training, generator)

        b, ng, g, d = feats.shape
        feats = self.mlp_mixer_3d(feats, generator)
        key = feats if pos is None else feats + pos
        flat_t = token.reshape(b * ng, 1, d)
        summary = self.self_attn(flat_t, key.reshape(b * ng, g, d),
                                 feats.reshape(b * ng, g, d), generator)
        t = self.norm1(flat_t + drop(summary))
        ff = self.linear2(drop(torch.relu(self.linear1(t))))
        token = self.norm2(t + drop(ff)).reshape(b, ng, d)
        if not self.last_layer:
            fused = self.fusion_all_groups(
                feats.permute(0, 2, 1, 3).reshape(b, g, ng * d))
            fkey = fused if pos is None else fused + pos
            groups = []
            for i in range(ng):
                q = feats[:, i] if pos is None else feats[:, i] + pos
                ca = getattr(self, f"cross_attn_{i}")(q, fkey, fused,
                                                      generator)
                groups.append(getattr(self, f"ffn_{i}")(feats[:, i], ca,
                                                        generator))
            feats = torch.stack(groups, dim=1)
        return token, feats


class MPPNetTransformer(nn.Module):
    """The grouped encoder. src (B, F*G, D) frame-major -> (hs (B, NG*D),
    tokens (L, B, NG, D)). With more frames than groups the strided frame
    groups (i, i+s, i+2s, ...) are concatenated on the channels and fused
    first."""

    FLAX_LEAVES = ("token",)

    def __init__(self, model_cfg, grid_size: int = 4):
        super().__init__()
        cfg = model_cfg
        self.d = d = int(cfg["hidden_dim"])
        self.ng = ng = int(cfg["num_groups"])
        self.nf = nf = int(cfg["num_frames"])
        self.g = int(cfg["num_proxy_points"])
        self.stride = int(cfg.get("sequence_stride", ng))
        layers = int(cfg["enc_layers"])
        if nf > ng:
            self.fusion_all_group = MLPStack(nf // ng * d, d, d, 4)
            self.fusion_norm = FFNBlock(d, int(cfg["dim_feedforward"]))
        self.token = nn.Parameter(torch.zeros(ng, d))
        for li in range(layers):
            setattr(self, f"layer{li}", MPPNetEncoderLayer(
                d, int(cfg["nheads"]), int(cfg["dim_feedforward"]), ng,
                grid_size, int(cfg["use_mlp_mixer"]["hidden_dim"]),
                float(cfg.get("dropout", 0.1)), last_layer=li == layers - 1))
        self.layers = layers

    def forward(self, src, pos, generator=None):
        b = src.shape[0]
        d, ng, nf, g = self.d, self.ng, self.nf, self.g
        src = src.reshape(b, nf, g, d)
        if nf > ng:
            glen = nf // ng
            merged = torch.stack([torch.cat(
                [src[:, i + j * self.stride] for j in range(glen)], dim=-1)
                for i in range(ng)], dim=1)              # (B, NG, G, gl*D)
            feats = self.fusion_norm(src[:, :ng],
                                     self.fusion_all_group(merged), generator)
        else:
            feats = src
        token = self.token[None].expand(b, ng, d)
        tokens = []
        for li in range(self.layers):
            token, feats = getattr(self, f"layer{li}")(token, feats, pos,
                                                       generator)
            tokens.append(token)
        return token.reshape(b, ng * d), torch.stack(tokens, dim=0)


class SeqBoxPointNet(nn.Module):
    """The trajectory-box branch: per-frame Linear layers over the
    canonical box sequence (B, F, 8), a max over the frames, a feature and
    an auxiliary box regression -> (box_reg (B, code), feat (B, ch))."""

    def __init__(self, model_cfg, code_size: int = 7, in_dim: int = 8):
        super().__init__()
        ch = int(model_cfg["TRANS_INPUT"])
        self.conv1 = nn.Linear(in_dim, ch)
        self.conv2 = nn.Linear(ch, ch)
        self.conv3 = nn.Linear(ch, 2 * ch)
        self.fc_feat = nn.Linear(2 * ch, ch)
        self.fc_pre = nn.Linear(ch, ch)
        self.fc_reg = nn.Linear(ch, code_size)

    def forward(self, x):
        h = torch.relu(self.conv1(x))
        h = torch.relu(self.conv2(h))
        h = torch.relu(self.conv3(h))
        feat = torch.relu(self.fc_feat(h.amax(dim=1)))
        return self.fc_reg(torch.relu(self.fc_pre(feat))), feat
