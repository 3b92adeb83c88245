"""Building blocks of the SAUnet family, NCHW ``(batch, channels, time,
freq)``.

Counterpart of ``multipitch_architectures_tpu/models/layers.py``. Module
and parameter names follow the reference's ``state_dict`` keys
(libdl/nn_models), so the reference's checkpoints and the JAX package's
exported weights load without renaming.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import (TorchMultiheadAttention,
                             sinusoidal_positional_encoding)


def max_pool2d(x, kernel, stride=None, padding=(0, 0)):
    """torch ``nn.MaxPool2d`` semantics: -inf padding, floor output size."""
    return F.max_pool2d(x, kernel, stride or kernel, padding)


class HarmonicLayerNorm(nn.LayerNorm):
    """LayerNorm jointly over (channels, freq), time-invariant: the
    reference's ``nn.LayerNorm([n_chan, n_bins])`` applied to
    ``x.transpose(1, 2)`` (basic_cnns.py:30,160). The affine is stored
    (C, F); the JAX package stores it (F, C)."""

    def __init__(self, n_chan: int, n_bins: int, eps: float = 1e-5):
        super().__init__([n_chan, n_bins], eps=eps)

    def forward(self, x):  # (B, C, T, F)
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ConvBlock(nn.Sequential):
    """Conv2d -> LeakyReLU -> optional MaxPool2d -> Dropout, as the
    reference's ``nn.Sequential`` (so its conv is ``<name>.0``)."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int], stride=(1, 1), padding=(0, 0),
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 pool_kernel: Optional[Tuple[int, int]] = None,
                 pool_stride: Optional[Tuple[int, int]] = None,
                 pool_padding=(0, 0)):
        layers = [nn.Conv2d(in_channels, features, kernel, stride, padding),
                  nn.LeakyReLU(a_lrelu)]
        if pool_kernel is not None:
            layers.append(nn.MaxPool2d(pool_kernel, pool_stride or pool_kernel,
                                       pool_padding))
        layers.append(nn.Dropout(p_dropout))
        super().__init__(*layers)


class DoubleConv(nn.Module):
    """Two Conv-BN-ReLU stages (unet_cnns.py:30-82) in the reference's
    ``double_conv`` Sequential. ``convdrop=None`` gives the plain layout
    (convs at indices 0 and 3); a number, 0.0 included, inserts
    Dropout(p=convdrop) after each stage (convs at 0 and 4)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None, kernel=(3, 3),
                 padding=(1, 1), convdrop: Optional[float] = 0.0):
        super().__init__()
        mid = mid_channels or out_channels
        layers = []
        for c_in, c_out in ((in_channels, mid), (mid, out_channels)):
            layers += [nn.Conv2d(c_in, c_out, kernel, padding=padding),
                       nn.BatchNorm2d(c_out, eps=1e-5, momentum=0.1),
                       nn.ReLU()]
            if convdrop is not None:
                layers.append(nn.Dropout(convdrop))
        self.double_conv = nn.Sequential(*layers)

    def forward(self, x):
        return self.double_conv(x)


class TransformerEncLayer(nn.Module):
    """Post-norm transformer encoder over the flattened (H·W) tokens of a
    bottleneck map, with the reference's extra Q/K/V/O projections around
    the attention core (unet_cnns.py:107-159). Input and output NCHW
    ``(B, E, H, W)``. ``pos_encoding`` is None, ``'sinusoidal'`` (a table
    computed, not stored, as in the reference) or ``'learnable'`` (a
    ``(max_len, E)`` parameter ``pe``)."""

    def __init__(self, embed_dim: int, num_heads: int = 8, mlp_dim: int = 512,
                 p_dropout: float = 0.2, pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch", max_len: int = 600):
        super().__init__()
        if pos_encoding not in (None, "sinusoidal", "learnable"):
            raise ValueError(f"unsupported pos_encoding {pos_encoding!r}")
        e = embed_dim
        self.pos_encoding = pos_encoding
        if pos_encoding == "learnable":
            self.pe = nn.Parameter(torch.empty(max_len, e))
            _flax_kaiming_uniform(self.pe, None)
        else:
            self.register_buffer("pe", torch.from_numpy(
                sinusoidal_positional_encoding(max_len, e)), persistent=False)
        self.q_linear = nn.Linear(e, e, bias=False)
        self.k_linear = nn.Linear(e, e, bias=False)
        self.v_linear = nn.Linear(e, e, bias=False)
        self.attn = TorchMultiheadAttention(e, num_heads, mode=attn_mode)
        self.o_linear = nn.Linear(e, e, bias=False)
        self.layernorm1 = nn.LayerNorm(e, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(e, mlp_dim), nn.ReLU(),
                                 nn.Linear(mlp_dim, e))
        self.layernorm2 = nn.LayerNorm(e, eps=1e-5)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        b, e, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)             # (B, H·W, E)
        if self.pos_encoding is not None:
            pe = self.pe
            if self.pos_encoding == "sinusoidal" and \
                    tokens.shape[1] > pe.shape[0]:
                # the table is analytic: extend it for longer maps
                pe = torch.from_numpy(sinusoidal_positional_encoding(
                    tokens.shape[1], e)).to(tokens.device)
            tokens = self.dropout(tokens + pe[:tokens.shape[1]])
        attn_out = self.attn(self.q_linear(tokens), self.k_linear(tokens),
                             self.v_linear(tokens))
        attn_out = self.dropout(self.o_linear(attn_out))
        x1 = self.layernorm1(tokens + attn_out)
        x2 = self.layernorm2(x1 + self.dropout(self.mlp(x1)))
        return x2.transpose(1, 2).reshape(b, e, h, w)


def pitch_head(in_channels: int, n_chan_layers: Sequence[int],
               n_bins_in: int = 216, n_bins_out: int = 72,
               a_lrelu: float = 0.3, p_dropout: float = 0.2,
               context: int = 75):
    """The shared output head of the zoo (basic_cnns.py:168-188), the JAX
    package's ``PitchHead``. The reference keeps its three Sequentials at
    the model's top level, so this returns them for the model to hold as
    ``conv2``, ``conv3`` and ``conv4``:

    - conv2, binning to MIDI pitches: 3x3 conv, stride (1, 3) in freq
      (216 -> 72), then MaxPool (13, 1) s1 p(6, 0) and dropout;
    - conv3, time reduction: a (context, 1) conv over the window;
    - conv4: 1x1 conv, then a (1, last_kernel) conv and a sigmoid.

    Applied in that order they map (B, C, T, 216) to (B, 1, T-74, 72).
    """
    n_ch = n_chan_layers
    last_kernel = n_bins_in // 3 + 1 - n_bins_out
    conv2 = ConvBlock(in_channels, n_ch[1], (3, 3), stride=(1, 3),
                      padding=(1, 0), a_lrelu=a_lrelu, p_dropout=p_dropout,
                      pool_kernel=(13, 1), pool_stride=(1, 1),
                      pool_padding=(6, 0))
    conv3 = ConvBlock(n_ch[1], n_ch[2], (context, 1), a_lrelu=a_lrelu,
                      p_dropout=p_dropout)
    conv4 = nn.Sequential(
        nn.Conv2d(n_ch[2], n_ch[3], (1, 1)), nn.LeakyReLU(a_lrelu),
        nn.Dropout(p_dropout), nn.Conv2d(n_ch[3], 1, (1, last_kernel)),
        nn.Sigmoid())
    return {"conv2": conv2, "conv3": conv3, "conv4": conv4}


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator):
    """Seeded random weights, drawn from ``generator``. Convs and
    linears: He-uniform weights (variance-preserving through ReLU, so a
    full-depth random model still gives outputs that vary) and
    U(±1/√fan_in) biases; attention ``in_proj``: xavier-uniform with zero
    bias; norms: unit scale, zero shift and BatchNorm stats (0, 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, nonlinearity="relu",
                                     generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, TorchMultiheadAttention):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
            nn.init.zeros_(m.in_proj_bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()


def _flax_kaiming_uniform(p, generator):
    """flax ``kaiming_uniform`` of a 2-D ``(rows, cols)`` parameter:
    U(±sqrt(6 / rows)), flax taking axis -2 as fan-in."""
    bound = math.sqrt(6.0 / p.shape[0])
    nn.init.uniform_(p, -bound, bound, generator=generator)


@torch.no_grad()
def init_parameters_flax(model: nn.Module, generator: torch.Generator):
    """What the JAX package's ``model.init`` draws, drawn from
    ``generator`` (the trainer's initializer; the values differ, the
    distributions are flax's):

    - convs and linears, where the JAX module declares no initializer:
      flax's default LeCun truncated normal, std sqrt(1/fan_in)/0.8796
      cut at ±2 of that std, and zero biases;
    - attention ``in_proj`` and ``out_proj``: xavier-uniform weights and
      zero biases (JAX ``ops/attention.py:76-83``);
    - a learned positional encoding ``pe``: flax ``kaiming_uniform``
      (JAX ``models/layers.py:232``);
    - norms: unit scale and zero shift; BatchNorm statistics (0, 1).
    """
    attention = [m for m in model.modules()
                 if isinstance(m, TorchMultiheadAttention)]
    skip = {id(m.out_proj) for m in attention}
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and id(m) not in skip:
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
        elif isinstance(m, TransformerEncLayer) and \
                m.pos_encoding == "learnable":
            _flax_kaiming_uniform(m.pe, generator)
    for m in attention:
        nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
        nn.init.zeros_(m.in_proj_bias)
        nn.init.xavier_uniform_(m.out_proj.weight, generator=generator)
        nn.init.zeros_(m.out_proj.bias)
