"""DCNN and DRCNN (``deep_cnn_segm_sigmoid``) in plain PyTorch, written
from the published description (Weiß & Peeters, TASLP 2022, Table II;
the reference's ``libdl/nn_models/basic_cnns.py``, ``deep_cnn_segm_sigmoid``).

NCHW ``(B, 6, T, 216)`` HCQT windows in, ``(B, 1, T - 74, 72)`` sigmoid
pitch salience out: ``(B, 1, 1, 72)`` for one 75-frame window. Parameter
names follow the reference's ``state_dict`` keys (``layernorm``,
``conv1.0``, ``prefilt_list.{i}.0``, ``conv2.0``, ``conv3.0``,
``conv4.0``, ``conv4.3``), so one set of weights loads into this model
and into the program under test.

The model: ``n_prefilt_layers`` "prefilter" blocks at the input's full
resolution, each a 15 x 15 convolution, LeakyReLU, max-pool and dropout;
every block after the first adds its input back (an identity shortcut)
when ``residual`` (DRCNN) and not otherwise (DCNN). Then the pitch head:
a 3 x 3 convolution of stride 3 in frequency (216 bins to 72), a
(``context``, 1) convolution that reduces the window to one frame, a
1 x 1 convolution and the last (1, 216 // 3 + 1 - 72) convolution with a
sigmoid.

Departures from a textbook CNN, all as published:

- the input LayerNorm runs jointly over (harmonics, frequency) at each
  frame, with an affine of that shape;
- the max-pools have stride 1: (3, 1) with padding (1, 0) after each
  prefilter convolution and (13, 1) with padding (6, 0) after the
  head's first, so they smooth along time and keep the map's size;
- the time axis is reduced by the (75, 1) convolution of the head, not
  by pooling or striding, so a longer input gives one prediction per
  frame of ``T - 74``.

Nothing here imports the program under test.
"""

import torch
from torch import nn

CLASS = "deep_cnn_segm_sigmoid"


def block(c_in, c_out, kernel, a_lrelu, p_dropout, stride=1, padding=0,
          pool=None):
    """Conv, LeakyReLU, a stride-1 max-pool ``pool`` = (kernel, padding)
    if given, dropout: the reference's ``nn.Sequential`` (conv at 0)."""
    layers = [nn.Conv2d(c_in, c_out, kernel, stride, padding),
              nn.LeakyReLU(a_lrelu)]
    if pool is not None:
        layers.append(nn.MaxPool2d(pool[0], 1, pool[1]))
    return nn.Sequential(*layers, nn.Dropout(p_dropout))


class DeepCnn(nn.Module):
    """``deep_cnn_segm_sigmoid`` with the registry's arguments."""

    def __init__(self, n_chan_input=6, n_chan_layers=(20, 20, 10, 1),
                 n_prefilt_layers=1, residual=False, n_bins_in=216,
                 n_bins_out=12, a_lrelu=0.3, p_dropout=0.2, context=75):
        super().__init__()
        n = n_chan_layers
        self.residual = residual
        self.layernorm = nn.LayerNorm([n_chan_input, n_bins_in])

        def prefilter(c_in):
            return block(c_in, n[0], 15, a_lrelu, p_dropout, padding=7,
                         pool=((3, 1), (1, 0)))

        self.conv1 = prefilter(n_chan_input)
        self.prefilt_list = nn.ModuleList(
            prefilter(n[0]) for _ in range(n_prefilt_layers - 1))
        self.conv2 = block(n[0], n[1], 3, a_lrelu, p_dropout, stride=(1, 3),
                           padding=(1, 0), pool=((13, 1), (6, 0)))
        self.conv3 = block(n[1], n[2], (context, 1), a_lrelu, p_dropout)
        self.conv4 = nn.Sequential(
            nn.Conv2d(n[2], n[3], 1), nn.LeakyReLU(a_lrelu),
            nn.Dropout(p_dropout),
            nn.Conv2d(n[3], 1, (1, n_bins_in // 3 + 1 - n_bins_out)),
            nn.Sigmoid())

    def forward(self, x):
        x = self.layernorm(x.transpose(1, 2)).transpose(1, 2)
        x = self.conv1(x)
        for layer in self.prefilt_list:
            x = x + layer(x) if self.residual else layer(x)
        return self.conv4(self.conv3(self.conv2(x)))


def build(model_cfg):
    """The reference model of a configuration file's ``model`` entry."""
    if model_cfg["class"] != CLASS:
        raise ValueError(f"no DCNN/DRCNN reference for "
                         f"{model_cfg['class']!r}")
    args = dict(model_cfg["args"])
    args["n_chan_layers"] = tuple(args["n_chan_layers"])
    return DeepCnn(**args)
