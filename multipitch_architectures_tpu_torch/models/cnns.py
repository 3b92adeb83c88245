"""The CNNs of the model zoo: the paper's CNN and DCNN/DRCNN, the
log-softmax heads and the two time-strided CNNs.

Counterpart of the JAX package's ``models/cnns.py``: its six classes.
NCHW ``(B, harmonics, T, F)`` in, ``(B, 1, T-74, 72)`` out: ``(B, 1, 1,
72)`` for one 75-frame window (``n_ch_out`` log-probability channels for
the log-softmax heads). In the segmentation CNNs every op is stride 1 in
time, so a whole padded recording gives every framewise prediction in one
pass (``eval.predict_dense``); ``BasicCnn`` and ``BasicCnnPool`` stride
or pool the time axis of exactly one window.
"""

from typing import Sequence

import torch
from torch import nn

from ..ops.conv import Conv2d
from ..utils.profiling import span
from .layers import ConvBlock, HarmonicLayerNorm, PitchHead


def _prefilter(n_chan_in, n_chan, a_lrelu, p_dropout):
    """The 15x15 prefilter block with max-pool (3, 1) s1 p(1, 0)
    (basic_cnns.py:162-167)."""
    return ConvBlock(n_chan_in, n_chan, (15, 15), padding=(7, 7),
                     a_lrelu=a_lrelu, p_dropout=p_dropout,
                     pool_kernel=(3, 1), pool_stride=(1, 1),
                     pool_padding=(1, 0))


class _SegmCnn(nn.Module):
    """The segmentation CNN: the trunk of the JAX package's
    ``_SegmTrunk`` (basic_cnns.py:159-167), the harmonic LayerNorm and
    the prefilter ``conv1``; ``n_prefilt_layers - 1`` more prefilter
    blocks (``prefilt_list.{i}``), each with an identity shortcut when
    ``residual``; then the pitch head ``conv2``..``conv4``. Keys are the
    reference's: ``layernorm``, ``conv1.0``, ``prefilt_list.{i}.0``,
    ``conv2.0`` .. ``conv4.3``.

    Spans ``cnn.prefilter`` (the LayerNorm and the prefilter stack) and
    ``cnn.head`` (``conv2``..``conv4``)."""

    def __init__(self, n_chan_input, n_chan_layers, n_prefilt_layers,
                 residual, n_bins_in, n_bins_out, a_lrelu, p_dropout):
        super().__init__()
        n_ch = n_chan_layers
        self.residual = residual
        self.layernorm = HarmonicLayerNorm(n_chan_input, n_bins_in)
        self.conv1 = _prefilter(n_chan_input, n_ch[0], a_lrelu, p_dropout)
        self.prefilt_list = nn.ModuleList(
            _prefilter(n_ch[0], n_ch[0], a_lrelu, p_dropout)
            for _ in range(n_prefilt_layers - 1))
        PitchHead(n_ch[0], n_ch, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)

    def forward(self, x):
        with span("cnn.prefilter"):
            x = self.conv1(self.layernorm(x))
            for block in self.prefilt_list:
                h = block(x)
                x = x + h if self.residual else h
        with span("cnn.head"):
            return self.conv4(self.conv3(self.conv2(x)))


class BasicCnnSegmSigmoid(_SegmCnn):
    """Reference ``basic_cnn_segm_sigmoid`` (basic_cnns.py:133-195), the
    paper's CNN:XS..L: stride 1 in time, sigmoid pitch-salience head."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (20, 20, 10, 1),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2):
        super().__init__(n_chan_input, n_chan_layers, 1, False, n_bins_in,
                         n_bins_out, a_lrelu, p_dropout)


class DeepCnnSegmSigmoid(_SegmCnn):
    """Reference ``deep_cnn_segm_sigmoid`` (basic_cnns.py:342-423), the
    paper's DCNN (``residual=False``) and DRCNN (``residual=True``):
    ``n_prefilt_layers`` 15x15 prefilter blocks, the identity residual
    adding no parameter."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (20, 20, 10, 1),
                 n_prefilt_layers: int = 1, residual: bool = False,
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2):
        super().__init__(n_chan_input, n_chan_layers, n_prefilt_layers,
                         residual, n_bins_in, n_bins_out, a_lrelu, p_dropout)


class _StridedCnn(nn.Module):
    """``BasicCnn`` / ``BasicCnnPool``: the harmonic LayerNorm, then
    ``conv1``..``conv3`` (``ConvBlock``s that reduce a 75-frame window to
    one frame) and ``conv4``, a 1x1 conv and the (1, last) conv with a
    sigmoid (``conv4.0``, ``conv4.3``), the reference's keys."""

    def __init__(self, n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                 a_lrelu, p_dropout, blocks):
        super().__init__()
        n_ch = n_chan_layers
        kw = dict(a_lrelu=a_lrelu, p_dropout=p_dropout)
        self.layernorm = HarmonicLayerNorm(n_chan_input, n_bins_in)
        c_in = n_chan_input
        for i, block in enumerate(blocks, 1):
            setattr(self, f"conv{i}", ConvBlock(c_in, n_ch[i - 1], **block,
                                                **kw))
            c_in = n_ch[i - 1]
        self.conv4 = nn.Sequential(
            Conv2d(n_ch[2], n_ch[3], (1, 1)), nn.LeakyReLU(a_lrelu),
            nn.Dropout(p_dropout),
            Conv2d(n_ch[3], 1, (1, n_bins_in // 3 + 1 - n_bins_out)),
            nn.Sigmoid())

    def forward(self, x):
        return self.conv4(self.conv3(self.conv2(self.conv1(
            self.layernorm(x)))))


class BasicCnn(_StridedCnn):
    """Reference ``basic_cnn`` (basic_cnns.py:5-65): the time axis of a
    75-frame window reduced by stride: 15x15 conv and max-pool (2, 1),
    3x3 conv of stride 3 and max-pool (2, 1), then a (6, 1) conv."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (20, 20, 10, 1),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, (
                             dict(kernel=(15, 15), padding=(7, 7),
                                  pool_kernel=(2, 1)),
                             dict(kernel=(3, 3), stride=(3, 3),
                                  pool_kernel=(2, 1)),
                             dict(kernel=(6, 1))))


class BasicCnnPool(_StridedCnn):
    """Reference ``basic_cnn_pool`` (basic_cnns.py:68-130): max-pools
    instead of the stride, (8, 1) and (3, 3), then a (3, 1) conv."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (20, 20, 10, 1),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, (
                             dict(kernel=(15, 15), padding=(7, 7),
                                  pool_kernel=(8, 1)),
                             dict(kernel=(3, 3), padding=(1, 1),
                                  pool_kernel=(3, 3)),
                             dict(kernel=(3, 1))))


class BasicCnnSegmLogSoftmax(_SegmCnn):
    """Reference ``basic_cnn_segm_logsoftmax`` (basic_cnns.py:198-264):
    the segmentation CNN with ``n_ch_out`` output channels of the last
    conv (``conv4.3``) and a log-softmax over them, for CTC-style losses:
    ``(B, n_ch_out, T-74, n_bins_out)``."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (20, 20, 10, 1),
                 n_ch_out: int = 2, n_bins_in: int = 216,
                 n_bins_out: int = 12, a_lrelu: float = 0.3,
                 p_dropout: float = 0.2):
        super().__init__(n_chan_input, n_chan_layers, 1, False, n_bins_in,
                         n_bins_out, a_lrelu, p_dropout)
        last = self.conv4[3]
        self.conv4[3] = Conv2d(n_chan_layers[3], n_ch_out,
                               last.kernel_size)
        self.conv4[4] = nn.LogSoftmax(dim=1)


class BasicCnnSegmBlankLogSoftmax(_SegmCnn):
    """Reference ``basic_cnn_segm_blank_logsoftmax`` (basic_cnns.py:
    267-339): a blank symbol's bin for MCTC, from the (1, 72) conv
    ``conv5b``, concatenated before the pitch bins of ``conv5a``, then the
    log-softmax over the ``n_ch_out`` channels: ``(B, n_ch_out, T-74,
    n_bins_out + 1)``. ``conv4`` keeps only its 1x1 conv block."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (20, 20, 10, 1),
                 n_ch_out: int = 2, n_bins_in: int = 216,
                 n_bins_out: int = 12, a_lrelu: float = 0.3,
                 p_dropout: float = 0.2):
        super().__init__(n_chan_input, n_chan_layers, 1, False, n_bins_in,
                         n_bins_out, a_lrelu, p_dropout)
        last = self.conv4[3]
        self.conv4 = self.conv4[:3]
        self.conv5a = Conv2d(n_chan_layers[3], n_ch_out, last.kernel_size)
        self.conv5b = Conv2d(n_chan_layers[3], n_ch_out, (1, 72))

    def forward(self, x):
        x = self.conv1(self.layernorm(x))
        h = self.conv4(self.conv3(self.conv2(x)))
        return torch.log_softmax(torch.cat([self.conv5b(h), self.conv5a(h)],
                                           dim=3), dim=1)
