"""The segmentation CNNs of the model zoo: the paper's CNN and DCNN/DRCNN.

Counterpart of the JAX package's ``models/cnns.py``, so far for the two
classes that the experiment registry uses. NCHW ``(B, harmonics, T, F)``
in, ``(B, 1, T-74, 72)`` out: ``(B, 1, 1, 72)`` for one 75-frame window.
Every op is stride 1 in time, so a whole padded recording gives every
framewise prediction in one pass (``eval.predict_dense``).
"""

from typing import Sequence

from torch import nn

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
    ``conv2.0`` .. ``conv4.3``."""

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
        x = self.conv1(self.layernorm(x))
        for block in self.prefilt_list:
            h = block(x)
            x = x + h if self.residual else h
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
