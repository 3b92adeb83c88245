"""Building blocks of the model zoo, NCHW ``(batch, channels, time,
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
from ..ops.conv import Conv2d
from ..ops.lstm import TorchLSTM


def leaky_relu(x, negative_slope):
    return F.leaky_relu(x, negative_slope)


def max_pool2d(x, kernel, stride=None, padding=(0, 0)):
    """torch ``nn.MaxPool2d`` semantics: -inf padding, floor output size."""
    return F.max_pool2d(x, kernel, stride or kernel, padding)


def max_pool_with_indices_freq(x, k: int):
    """Max-pool NCHW ``x`` along frequency by the exact factor ``k``:
    ``(pooled, idx)``, ``idx`` the position of each window's first maximum
    within its ``k`` bins (JAX ``models/layers.py:180``), not the
    flattened-plane index of ``F.max_pool2d(return_indices=True)``. The
    freq U-Nets' factors divide 216 exactly."""
    b, c, t, f = x.shape
    if f % k:
        raise ValueError(f"{f} frequency bins do not pool by {k}")
    xr = x.reshape(b, c, t, f // k, k)
    return xr.amax(-1), xr.argmax(-1)


def max_unpool_freq(x, idx, k: int):
    """Inverse of :func:`max_pool_with_indices_freq`: each value back at
    its window's index, zeros elsewhere."""
    b, c, t, f = x.shape
    onehot = F.one_hot(idx, k).to(x.dtype)             # (B, C, T, F, k)
    return (x[..., None] * onehot).reshape(b, c, t, f * k)


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
        layers = [Conv2d(in_channels, features, kernel, stride, padding),
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
    Dropout(p=convdrop) after each stage (convs at 0 and 4).
    ``alt_order`` is the pre-activation order ELU-BN-Dropout-Conv, twice
    (BNs at 1 and 5, convs at 3 and 7; an ``nn.Identity`` holds the
    dropout's place when ``convdrop`` is None). ``residual`` adds a
    1x1-conv shortcut of the input, ``resize``."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None, kernel=(3, 3),
                 padding=(1, 1), convdrop: Optional[float] = 0.0,
                 residual: bool = False, alt_order: bool = False):
        super().__init__()
        mid = mid_channels or out_channels
        layers = []
        for c_in, c_out in ((in_channels, mid), (mid, out_channels)):
            conv = Conv2d(c_in, c_out, kernel, padding=padding)
            if alt_order:
                layers += [nn.ELU(), nn.BatchNorm2d(c_in, eps=1e-5,
                                                    momentum=0.1),
                           nn.Identity() if convdrop is None
                           else nn.Dropout(convdrop), conv]
                continue
            layers += [conv, nn.BatchNorm2d(c_out, eps=1e-5, momentum=0.1),
                       nn.ReLU()]
            if convdrop is not None:
                layers.append(nn.Dropout(convdrop))
        self.double_conv = nn.Sequential(*layers)
        self.resize = (Conv2d(in_channels, out_channels, (1, 1))
                       if residual else None)

    def forward(self, x):
        h = self.double_conv(x)
        return h if self.resize is None else self.resize(x) + h


class SingleConvSELU(nn.Sequential):
    """Conv2d -> SELU, the working block that the reference's broken
    ``single_conv`` / ``single_conv_SELU`` call sites intend (JAX
    ``models/layers.py:156``); its conv is ``<name>.0``."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3),
                 padding=(1, 1)):
        super().__init__(Conv2d(in_channels, features, kernel,
                                padding=padding), nn.SELU())


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
        return self._encode(tokens).transpose(1, 2).reshape(b, e, h, w)

    def _encode(self, tokens):
        """The encoder on ``(B, L, E)`` tokens."""
        e = tokens.shape[2]
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
        return self.layernorm2(x1 + self.dropout(self.mlp(x1)))


class TransformerTemporalEncLayer(TransformerEncLayer):
    """Attention over time only (unet_cnns.py:162-217): token ``t`` holds
    the map's (channel x freq) features flattened channel-major, ``(B, C,
    T, F)`` -> ``(B, T, C·F)``, and the output is split back the same way.
    ``C·F`` must be ``embed_dim``. The positional table has ``max_len``
    (174) rows, as in the JAX package, and a longer map raises: it is not
    extended."""

    def __init__(self, embed_dim: int, num_heads: int = 8, mlp_dim: int = 512,
                 p_dropout: float = 0.2, pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch", max_len: int = 174):
        super().__init__(embed_dim, num_heads, mlp_dim, p_dropout,
                         pos_encoding, attn_mode, max_len)

    def forward(self, x):
        b, c, t, f = x.shape
        if c * f != self.pe.shape[1]:
            raise ValueError(f"{c} channels x {f} bins is not the embedding "
                             f"width {self.pe.shape[1]}")
        if self.pos_encoding is not None and t > self.pe.shape[0]:
            raise ValueError(f"{t} time steps exceed the positional table's "
                             f"{self.pe.shape[0]} rows")
        tokens = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
        return self._encode(tokens).reshape(b, t, c, f).permute(0, 2, 1, 3)


class BLSTMTemporalEncLayer(nn.Module):
    """BLSTM over time with each step's (channel x freq) features
    flattened channel-major (unet_cnns.py:220-243): ``(B, C, T, F)`` ->
    ``(B, T, C·F)``, and the ``(B, T, 2H)`` output split channel-major
    back onto the map as ``(B, 2H/F, T, F)``. ``n_chan · n_bins`` is the
    reference's ``embed_dim``."""

    def __init__(self, n_chan: int, n_bins: int, hidden_size: int,
                 num_layers: int = 1):
        super().__init__()
        if (2 * hidden_size) % n_bins:
            raise ValueError(f"2 x hidden_size {2 * hidden_size} does not "
                             f"split onto {n_bins} frequency bins")
        self.blstm = TorchLSTM(n_chan * n_bins, hidden_size, num_layers)

    def forward(self, x):
        b, c, t, f = x.shape
        out = self.blstm(x.permute(0, 2, 1, 3).reshape(b, t, c * f))
        return out.reshape(b, t, -1, f).permute(0, 2, 1, 3)


def polyphony_head(in_channels: int, mid_channels: int, out_channels: int,
                   a_lrelu: float = 0.3, p_dropout: float = 0.2,
                   relu_out: bool = True):
    """The degree-of-polyphony head ``convP`` (unet_cnns.py:2040-2047,
    2311-2318): conv (2, 5) -> LeakyReLU -> max-pool (2, 5) stride (1, 2)
    -> dropout -> conv (2, 3), all unpadded, then a ReLU unless
    ``relu_out`` is false (raw logits). Convs at ``.0`` and ``.4``; on
    the 4 x 13 bottleneck of a window it gives 1 x 1."""
    layers = [Conv2d(in_channels, mid_channels, (2, 5)),
              nn.LeakyReLU(a_lrelu), nn.MaxPool2d((2, 5), (1, 2)),
              nn.Dropout(p_dropout),
              Conv2d(mid_channels, out_channels, (2, 3))]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu_out else []))


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
        Conv2d(n_ch[2], n_ch[3], (1, 1)), nn.LeakyReLU(a_lrelu),
        nn.Dropout(p_dropout), Conv2d(n_ch[3], 1, (1, last_kernel)),
        nn.Sigmoid())
    return {"conv2": conv2, "conv3": conv3, "conv4": conv4}


class PitchHead(nn.ModuleDict):
    """The shared output head as one module (the JAX package's
    ``PitchHead``): :func:`pitch_head`'s ``conv2``, ``conv3`` and
    ``conv4``, applied in that order. A model adds its three parts at its
    own top level (:meth:`attach`), where the reference keeps them."""

    def __init__(self, in_channels: int, n_chan_layers: Sequence[int],
                 n_bins_in: int = 216, n_bins_out: int = 72,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 context: int = 75):
        super().__init__(pitch_head(in_channels, n_chan_layers, n_bins_in,
                                    n_bins_out, a_lrelu, p_dropout, context))

    def attach(self, model: nn.Module):
        for name, m in self.items():
            model.add_module(name, m)

    def forward(self, x):
        return self.conv4(self.conv3(self.conv2(x)))


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
        elif isinstance(m, nn.LSTM):
            _lstm_uniform(m, generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()


def _lstm_uniform(m, generator):
    """Every LSTM weight and bias U(±1/sqrt(H)): ``nn.LSTM``'s own
    initialisation and the JAX package's ``TorchLSTM`` init."""
    bound = 1.0 / math.sqrt(m.hidden_size)
    for p in m.parameters():
        nn.init.uniform_(p, -bound, bound, generator=generator)


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
    - a learned positional encoding ``pe`` (of the spatial and the
      temporal transformer layers): flax ``kaiming_uniform`` (JAX
      ``models/layers.py:232, 270``);
    - LSTM weights and biases: U(±1/sqrt(H)) (JAX ``ops/lstm.py:52``);
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
        elif isinstance(m, nn.LSTM):
            _lstm_uniform(m, generator)
    for m in attention:
        nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
        nn.init.zeros_(m.in_proj_bias)
        nn.init.xavier_uniform_(m.out_proj.weight, generator=generator)
        nn.init.zeros_(m.out_proj.bias)
