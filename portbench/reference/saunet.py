"""SAUnet (``simple_u_net_doubleselfattn``) in plain PyTorch, written from
the published description (Weiß & Peeters, TASLP 2022, Fig. 3 and
Table II; the reference's ``libdl/nn_models/unet_cnns.py``).

NCHW ``(B, 6, 75, 216)`` HCQT windows in, ``(B, 1, 1, 72)`` sigmoid
pitch salience out. Parameter names follow the reference's
``state_dict`` keys, so one set of weights loads into this model and
into the program under test.

Departures from a textbook U-Net, all as published:

- the input LayerNorm runs jointly over (harmonics, frequency) at each
  frame;
- the two transformer layers at the bottleneck feed their
  ``(B, tokens, E)`` tensors to a multi-head attention that takes its
  first axis as the sequence, so each token position attends across the
  samples of the batch it was given; the caller's batch composition is
  part of the result;
- the decoder upsamples bilinearly with ``align_corners=True`` and pads
  to the skip connection's size before concatenating.

Nothing here imports the program under test.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def geometry(scalefac, n_ch0):
    """Encoder and decoder (in, mid, out, kernel) ladder of the large-kernel
    U-Net: widths 64..1024 over ``scalefac``, kernels 15, 15, 9, 5, 3
    down and mirrored up."""
    sc = scalefac
    enc_out = [64 // sc, 128 // sc, 256 // sc, 512 // sc, 1024 // (2 * sc)]
    enc_k = [15, 15, 9, 5, 3]
    dec = [(512 // (2 * sc), 1024 // (2 * sc), 3),
           (256 // (2 * sc), 512 // (2 * sc), 5),
           (128 // (2 * sc), 256 // (2 * sc), 9),
           (n_ch0, 128 // (2 * sc), 15)]
    return enc_out, enc_k, dec


def sinusoidal_table(length, dim):
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


class DoubleConv(nn.Module):
    """(conv, BatchNorm, ReLU, Dropout(convdrop)) twice."""

    def __init__(self, c_in, c_out, c_mid, k, convdrop=0.0):
        super().__init__()
        p = k // 2
        self.double_conv = nn.Sequential(
            nn.Conv2d(c_in, c_mid, k, padding=p), nn.BatchNorm2d(c_mid),
            nn.ReLU(), nn.Dropout(convdrop),
            nn.Conv2d(c_mid, c_out, k, padding=p), nn.BatchNorm2d(c_out),
            nn.ReLU(), nn.Dropout(convdrop))

    def forward(self, x):
        return self.double_conv(x)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters; attends over axis 0 of the
    ``(B, L, E)`` tensors it is given, at each position of axis 1."""

    def __init__(self, e, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e))
        self.out_proj = nn.Linear(e, e)

    def forward(self, q, k, v):
        b, l, e = q.shape
        hd = e // self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(t):  # (B, L, E) -> (L, H, B, hd)
            return t.reshape(b, l, self.heads, hd).permute(1, 2, 0, 3)

        q = heads(F.linear(q, wq, bq)) * (1.0 / math.sqrt(hd))
        k = heads(F.linear(k, wk, bk))
        v = heads(F.linear(v, wv, bv))
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(w, v).permute(2, 0, 1, 3).reshape(b, l, e)
        return self.out_proj(out)


class TransformerLayer(nn.Module):
    """Post-norm encoder layer with extra Q/K/V/O projections around the
    attention, on the flattened tokens of an NCHW map."""

    def __init__(self, e, heads, mlp_dim, p_dropout, pos_encoding):
        super().__init__()
        self.pos_encoding = pos_encoding
        self.q_linear = nn.Linear(e, e, bias=False)
        self.k_linear = nn.Linear(e, e, bias=False)
        self.v_linear = nn.Linear(e, e, bias=False)
        self.attn = MultiheadAttention(e, heads)
        self.o_linear = nn.Linear(e, e, bias=False)
        self.layernorm1 = nn.LayerNorm(e)
        self.mlp = nn.Sequential(nn.Linear(e, mlp_dim), nn.ReLU(),
                                 nn.Linear(mlp_dim, e))
        self.layernorm2 = nn.LayerNorm(e)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        b, e, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)                    # (B, L, E)
        if self.pos_encoding == "sinusoidal":
            pe = sinusoidal_table(t.shape[1], e).to(t.device, t.dtype)
            t = self.dropout(t + pe)
        a = self.attn(self.q_linear(t), self.k_linear(t), self.v_linear(t))
        x1 = self.layernorm1(t + self.dropout(self.o_linear(a)))
        t = self.layernorm2(x1 + self.dropout(self.mlp(x1)))
        return t.transpose(1, 2).reshape(b, e, h, w)


def up_concat(x1, x2):
    """x1 upsampled by 2 (bilinear, align_corners), zero-padded to x2's
    size, concatenated after x2."""
    x1 = F.interpolate(x1, scale_factor=2, mode="bilinear",
                       align_corners=True)
    dh, dw = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
    x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return torch.cat([x2, x1], dim=1)


class SAUnet(nn.Module):
    """``simple_u_net_doubleselfattn`` with the registry's arguments."""

    def __init__(self, n_chan_input=6, n_chan_layers=(64, 30, 20, 10),
                 n_bins_in=216, n_bins_out=72, a_lrelu=0.3, p_dropout=0.2,
                 scalefac=16, embed_dim=32, num_heads=8, mlp_dim=512,
                 pos_encoding=None, convdrop=0.0, context=75):
        super().__init__()
        enc_out, enc_k, dec = geometry(scalefac, n_chan_layers[0])
        if enc_out[4] != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not the bottleneck "
                             f"width {enc_out[4]}")
        self.layernorm = nn.LayerNorm([n_chan_input, n_bins_in])
        self.inc = DoubleConv(n_chan_input, enc_out[0], enc_out[0],
                              enc_k[0], convdrop)
        for i in range(1, 5):
            setattr(self, f"down{i}", nn.Sequential(
                nn.MaxPool2d(2), DoubleConv(enc_out[i - 1], enc_out[i],
                                            enc_out[i], enc_k[i], convdrop)))
        self.attention1 = TransformerLayer(embed_dim, num_heads, mlp_dim,
                                           p_dropout, pos_encoding)
        self.attention2 = TransformerLayer(embed_dim, num_heads, mlp_dim,
                                           p_dropout, None)
        c = enc_out[4]
        for i, ((out, mid, k), skip) in enumerate(
                zip(dec, enc_out[3::-1]), start=1):
            setattr(self, f"upconv{i}", DoubleConv(c + skip, out, mid, k,
                                                   convdrop))
            c = out
        n = n_chan_layers
        self.conv2 = nn.Sequential(
            nn.Conv2d(c, n[1], 3, stride=(1, 3), padding=(1, 0)),
            nn.LeakyReLU(a_lrelu), nn.MaxPool2d((13, 1), 1, (6, 0)),
            nn.Dropout(p_dropout))
        self.conv3 = nn.Sequential(nn.Conv2d(n[1], n[2], (context, 1)),
                                   nn.LeakyReLU(a_lrelu),
                                   nn.Dropout(p_dropout))
        self.conv4 = nn.Sequential(
            nn.Conv2d(n[2], n[3], 1), nn.LeakyReLU(a_lrelu),
            nn.Dropout(p_dropout),
            nn.Conv2d(n[3], 1, (1, n_bins_in // 3 + 1 - n_bins_out)),
            nn.Sigmoid())

    def forward(self, x):
        x = self.layernorm(x.transpose(1, 2)).transpose(1, 2)
        skips = [self.inc(x)]
        for i in range(1, 5):
            skips.append(getattr(self, f"down{i}")(skips[-1]))
        h = self.attention2(self.attention1(skips[4]))
        for i, skip in zip(range(1, 5), skips[3::-1]):
            h = getattr(self, f"upconv{i}")(up_concat(h, skip))
        return self.conv4(self.conv3(self.conv2(h)))


def build(model_cfg):
    """The reference model of a configuration file's ``model`` entry."""
    if model_cfg["class"] != "simple_u_net_doubleselfattn":
        raise ValueError(f"no SAUnet reference for {model_cfg['class']!r}")
    args = dict(model_cfg["args"])
    args["n_chan_layers"] = tuple(args["n_chan_layers"])
    return SAUnet(**args)
