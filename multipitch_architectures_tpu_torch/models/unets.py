"""The U-Net family of the model zoo.

Counterpart of the JAX package's ``models/unets.py``: its 20 classes,
the paper's Unet, SAUnet, SAUSnet, BLUnet and PUnet among them. NCHW
``(B, harmonics, T, F)`` in, ``(B, 1, T-74, 72)`` out: ``(B, 1, 1, 72)``
for one 75-frame window (the polyphony U-Nets add their polyphony head's
output, the freq U-Net with the bottom stack its activity row).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention import TorchMultiheadAttention
from ..ops.conv import Conv2d
from ..ops.resize import up_concat_pad
from .layers import (BLSTMTemporalEncLayer, ConvBlock, DoubleConv, HarmonicLayerNorm,
                     PitchHead, SingleConvSELU, TransformerEncLayer,
                     TransformerTemporalEncLayer, leaky_relu,
                     max_pool_with_indices_freq, max_unpool_freq, pitch_head,
                     polyphony_head)


def _std_geometry(sc: int, n_ch0: int, kernels=(15, 9, 5, 3)):
    """Channel and kernel ladder of the standard simple_u_net family
    (unet_cnns.py:347-369): encoder widths 64..1024 / scalefac, decoder
    mirrored. ``kernels=(3, 3, 3, 3)`` gives the plain ``simple_u_net``
    (:265-287)."""
    k1, k2, k3, k4 = [(k, k) for k in kernels]
    enc = [
        dict(out=64 // sc, mid=64 // sc, k=k1),
        dict(out=128 // sc, mid=128 // sc, k=k1),
        dict(out=256 // sc, mid=256 // sc, k=k2),
        dict(out=512 // sc, mid=512 // sc, k=k3),
        dict(out=1024 // (sc * 2), mid=1024 // (sc * 2), k=k4),
    ]
    dec = [
        dict(out=512 // (sc * 2), mid=1024 // (sc * 2), k=k4),
        dict(out=256 // (sc * 2), mid=512 // (sc * 2), k=k3),
        dict(out=128 // (sc * 2), mid=256 // (sc * 2), k=k2),
        dict(out=n_ch0, mid=128 // (sc * 2), k=k1),
    ]
    return enc, dec


def _temporal_geometry(sc: int, n_ch0: int):
    """The asymmetric-pooling ladder of the u_net_temporal_* models
    (unet_cnns.py:1135-1189): 16/48/144/432/1728 channels over
    ``scalefac``, pooled (2, 3)."""
    enc = [
        dict(out=16 // sc, mid=16 // sc, k=(15, 15)),
        dict(out=48 // sc, mid=48 // sc, k=(15, 15)),
        dict(out=144 // sc, mid=144 // sc, k=(9, 9)),
        dict(out=432 // sc, mid=432 // sc, k=(5, 5)),
        dict(out=1728 // sc, mid=1728 // sc, k=(3, 3)),
    ]
    dec = [
        dict(out=144 // sc, mid=(1728 + 432) // (2 * sc), k=(3, 3)),
        dict(out=48 // sc, mid=144 // sc, k=(5, 5)),
        dict(out=16 // sc, mid=48 // sc, k=(9, 9)),
        dict(out=n_ch0, mid=48 // sc, k=(15, 15)),
    ]
    return enc, dec


def _pad(k):
    return (k[0] // 2, k[1] // 2)


def _block(c_in, g, convdrop=0.0, residual=False, alt_order=False):
    return DoubleConv(c_in, g["out"], g["mid"], g["k"], _pad(g["k"]),
                      convdrop=convdrop, residual=residual,
                      alt_order=alt_order)


def _add_encoder(model, n_chan_input, n_bins_in, enc, convdrop=0.0,
                 residual=False, alt_order=False, pool=(2, 2)):
    """``layernorm``, ``inc`` and ``down1``..``down4`` (each the
    reference's Sequential of a ``pool`` max-pool and a DoubleConv).
    ``residual`` applies to the down blocks only, as in the reference."""
    model.layernorm = HarmonicLayerNorm(n_chan_input, n_bins_in)
    model.inc = _block(n_chan_input, enc[0], convdrop, alt_order=alt_order)
    for i in range(1, 5):
        setattr(model, f"down{i}", nn.Sequential(
            nn.MaxPool2d(pool),
            _block(enc[i - 1]["out"], enc[i], convdrop, residual, alt_order)))


def _add_decoder(model, enc, dec, convdrop=0.0, residual=False,
                 widths=None, alt_order=False):
    """``upconv1``..``upconv4``. ``widths`` are the channels of
    [x5, x4, x3, x2, x1] as the decoder meets them (the encoder's by
    default). Returns the decoder's output width."""
    widths = widths or [g["out"] for g in enc[::-1]]
    c = widths[0]
    for i in range(1, 5):
        setattr(model, f"upconv{i}", _block(c + widths[i], dec[i - 1],
                                            convdrop, residual, alt_order))
        c = dec[i - 1]["out"]
    return c


def _levels(depth):
    """The levels that a varlayers depth processes, deepest first."""
    return [lv for lv in (5, 4, 3, 2, 1) if depth >= 6 - lv]


class _SimpleUNet(nn.Module):
    """Forward helpers of the simple_u_net classes. ``level_layers``
    names, for each level (1 = x1 .. 5 = x5), the modules that process
    its map, in order, just before the decoder meets it."""

    level_layers = {}
    upsamp = (2, 2)

    def _encoder(self, x):
        skips = [self.inc(self.layernorm(x))]
        for down in (self.down1, self.down2, self.down3, self.down4):
            skips.append(down(skips[-1]))
        return skips                                    # x1 .. x5

    def _process(self, h, level):
        for name in self.level_layers.get(level, ()):
            h = getattr(self, name)(h)
        return h

    def _decoder(self, skips):
        """The levels processed and up-concatenated, deepest first, each
        up-concat followed by its DoubleConv."""
        h = self._process(skips[4], 5)
        upconvs = (self.upconv1, self.upconv2, self.upconv3, self.upconv4)
        for level, upconv in zip((4, 3, 2, 1), upconvs):
            h = upconv(up_concat_pad(h, self._process(skips[level - 1],
                                                      level), self.upsamp))
        return h

    def _head(self, h):
        return self.conv4(self.conv3(self.conv2(h)))

    def forward(self, x):
        return self._head(self._decoder(self._encoder(x)))

    def _add_level_attention(self, depth, number, dims, make):
        """``attention{level}{a|b}``: ``number`` layers ``make(dim,
        letter)`` on each of the ``depth`` deepest levels."""
        self.level_layers = {}
        for level in _levels(depth):
            names = [f"attention{level}{letter}"
                     for letter in "ab"[:number]]
            for name in names:
                setattr(self, name, make(dims[level], name[-1]))
            self.level_layers[level] = names


def _check_embed_dim(embed_dim, enc):
    if enc[4]["out"] != embed_dim:
        raise ValueError(f"embed_dim {embed_dim} must equal the "
                         f"bottleneck width {enc[4]['out']}")


def _level_dims(embed_dim):
    """Attention widths per level: ``embed_dim`` at levels 5 and 4, then
    halved per level upward (JAX ``models/unets.py:333``)."""
    return {5: embed_dim, 4: embed_dim, 3: embed_dim // 2,
            2: embed_dim // 4, 1: embed_dim // 8}


class SimpleUNet(_SimpleUNet):
    """Reference ``simple_u_net`` (unet_cnns.py:251-325): 3x3 kernels at
    every level, ``scalefac`` 8 by default."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 8):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0],
                                 kernels=(3, 3, 3, 3))
        _add_encoder(self, n_chan_input, n_bins_in, enc)
        c = _add_decoder(self, enc, dec)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)


class SimpleUNetLargeKernels(_SimpleUNet):
    """Reference ``simple_u_net_largekernels`` (unet_cnns.py:333-407),
    the paper's Unet S/M/L/XL: kernel pyramid 15 -> 9 -> 5 -> 3 down,
    mirrored up."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _add_encoder(self, n_chan_input, n_bins_in, enc)
        c = _add_decoder(self, enc, dec)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)


class SimpleUNetSelfAttn(SimpleUNetLargeKernels):
    """Reference ``simple_u_net_selfattn`` (unet_cnns.py:415-492): one
    transformer encoder layer at the bottleneck, ``attention``."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, embed_dim: int = 32, num_heads: int = 8,
                 mlp_dim: int = 512, attn_mode: str = "cross_batch"):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac)
        _check_embed_dim(embed_dim, _std_geometry(scalefac, 1)[0])
        self.attention = TransformerEncLayer(embed_dim, num_heads, mlp_dim,
                                             attn_mode=attn_mode)
        self.level_layers = {5: ["attention"]}


class SimpleUNetDoubleSelfAttn(_SimpleUNet):
    """Reference ``simple_u_net_doubleselfattn`` (unet_cnns.py:496-575),
    the paper's SAUnet: two transformer encoder layers at the bottleneck,
    the first with the positional encoding, the second without.
    ``alt_order`` builds every DoubleConv in the pre-activation order
    (``layers.DoubleConv``).

    ``attn_mode`` selects the attention semantics (``ops.attention``);
    ``cross_batch:50`` lets a fused batch of 250 windows reproduce five
    reference test batches of 50.
    """

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, embed_dim: int = 32, num_heads: int = 8,
                 mlp_dim: int = 512, pos_encoding: Optional[str] = None,
                 convdrop: Optional[float] = 0.0, residual: bool = False,
                 alt_order: bool = False, attn_mode: str = "cross_batch"):
        super().__init__()
        self.alt_order = alt_order
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _check_embed_dim(embed_dim, enc)
        _add_encoder(self, n_chan_input, n_bins_in, enc, convdrop, residual,
                     alt_order)
        for name, pe in (("attention1", pos_encoding), ("attention2", None)):
            setattr(self, name, TransformerEncLayer(
                embed_dim, num_heads, mlp_dim, pos_encoding=pe,
                attn_mode=attn_mode))
        self.level_layers = {5: ["attention1", "attention2"]}
        c = _add_decoder(self, enc, dec, convdrop, residual,
                         alt_order=alt_order)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)


class SimpleUNetSixSelfAttn(SimpleUNetLargeKernels):
    """Reference ``simple_u_net_sixselfattn`` (unet_cnns.py:579-666): six
    stacked bottleneck transformer layers ``attention1``..``attention6``,
    the positional encoding on the first only."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, embed_dim: int = 32, num_heads: int = 8,
                 mlp_dim: int = 512, pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch"):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac)
        _check_embed_dim(embed_dim, _std_geometry(scalefac, 1)[0])
        names = [f"attention{i}" for i in range(1, 7)]
        for name in names:
            setattr(self, name, TransformerEncLayer(
                embed_dim, num_heads, mlp_dim,
                pos_encoding=pos_encoding if name == "attention1" else None,
                attn_mode=attn_mode))
        self.level_layers = {5: names}


class SimpleUNetDoubleSelfAttnTwoLayers(_SimpleUNet):
    """Reference ``simple_u_net_doubleselfattn_twolayers``
    (unet_cnns.py:670-754), the paper's SAUSnet M/L/XL/XXL (exp181*): two
    attention layers at the bottleneck (``attention1/2``) and two on the
    deepest skip x4 (``attention3/4``); ``attention1`` and ``attention3``
    carry the positional encoding. At 75 x 216, x4 is 9 x 27: 243
    tokens."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, embed_dim: int = 32, num_heads: int = 8,
                 mlp_dim: int = 512, pos_encoding: Optional[str] = None,
                 convdrop: Optional[float] = 0.0, residual: bool = False,
                 attn_mode: str = "cross_batch"):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _check_embed_dim(embed_dim, enc)
        _add_encoder(self, n_chan_input, n_bins_in, enc, convdrop, residual)
        for i, pe in enumerate((pos_encoding, None, pos_encoding, None), 1):
            setattr(self, f"attention{i}", TransformerEncLayer(
                embed_dim, num_heads, mlp_dim, p_dropout, pos_encoding=pe,
                attn_mode=attn_mode))
        self.level_layers = {5: ["attention1", "attention2"],
                             4: ["attention3", "attention4"]}
        c = _add_decoder(self, enc, dec, convdrop, residual)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)


class SimpleUNetDoubleSelfAttnVarLayers(SimpleUNetLargeKernels):
    """Reference ``simple_u_net_doubleselfattn_varlayers``
    (unet_cnns.py:863-994): ``self_attn_number`` (0..2) transformer
    layers ``attention{level}{a|b}`` on each of the ``self_attn_depth``
    deepest levels, 5 first, ``a`` with the positional encoding. The
    widths are ``embed_dim`` at levels 5 and 4, then halved per level
    upward. Each level's map is processed just before the decoder meets
    it."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 8, embed_dim: int = 64, num_heads: int = 8,
                 mlp_dim: int = 512, self_attn_depth: int = 0,
                 self_attn_number: int = 2,
                 pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch"):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac)
        self._add_level_attention(
            self_attn_depth, self_attn_number, _level_dims(embed_dim),
            lambda dim, letter: TransformerEncLayer(
                dim, num_heads, mlp_dim, p_dropout,
                pos_encoding=pos_encoding if letter == "a" else None,
                attn_mode=attn_mode))


class SimpleUNetDoubleSelfAttnAllLayers(SimpleUNetDoubleSelfAttnVarLayers):
    """Reference ``simple_u_net_doubleselfattn_alllayers``
    (unet_cnns.py:758-857): two attention layers on every level, the
    varlayers model at depth 5 and number 2."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 8, embed_dim: int = 64, num_heads: int = 8,
                 mlp_dim: int = 512, self_attn_depth: int = 5,
                 self_attn_number: int = 2,
                 pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch"):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac, embed_dim, num_heads,
                         mlp_dim, self_attn_depth, self_attn_number,
                         pos_encoding, attn_mode)


class UNetBlstmVarLayers(_SimpleUNet):
    """Reference ``u_net_blstm_varlayers`` (unet_cnns.py:1000-1101), the
    paper's BLUnet M/L/XXL (exp186*): a BLSTM stack ``lstm{level}``
    (``lstm_number`` layers) on each of the ``lstm_depth`` deepest levels,
    5 first. Each level's map is processed just before the decoder meets
    it. A processed level has ``2 * hidden_size / F`` channels, F being
    its frequency bins (13 at level 5 of a 216-bin input). ``embed_dim``
    is the reference's argument, its bottleneck's C·F; the LSTM's width
    follows the map, as in the JAX package."""

    geometry = staticmethod(_std_geometry)
    pool = (2, 2)

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 8, embed_dim: int = 64,
                 hidden_size: int = 512, lstm_depth: int = 0,
                 lstm_number: int = 2):
        super().__init__()
        enc, dec = self.geometry(scalefac, n_chan_layers[0])
        _add_encoder(self, n_chan_input, n_bins_in, enc, pool=self.pool)
        widths = [g["out"] for g in enc[::-1]]          # x5, x4, .., x1
        self.level_layers = {}
        for level in _levels(lstm_depth):
            n_bins = n_bins_in // self.pool[1] ** (level - 1)
            setattr(self, f"lstm{level}", BLSTMTemporalEncLayer(
                widths[5 - level], n_bins, hidden_size, lstm_number))
            widths[5 - level] = 2 * hidden_size // n_bins
            self.level_layers[level] = [f"lstm{level}"]
        c = _add_decoder(self, enc, dec, widths=widths)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)


class UNetTemporalSelfAttnVarLayers(_SimpleUNet):
    """Reference ``u_net_temporal_selfattn_varlayers``
    (unet_cnns.py:1117-1252): attention over time only
    (``layers.TransformerTemporalEncLayer``, ``attention{level}{a|b}``,
    each ``embed_dim`` wide, so ``embed_dim`` must be the processed
    level's C·F), on the 16..1728-channel ladder pooled (2, 3): the
    frequency axis runs 216 -> 72 -> 24 -> 8 -> 2 (8/3 floored), and the
    decoder's up-concat pads back to each skip."""

    upsamp = (2, 3)

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 8, embed_dim: int = 64, num_heads: int = 8,
                 mlp_dim: int = 512, self_attn_depth: int = 0,
                 self_attn_number: int = 2,
                 pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch"):
        super().__init__()
        enc, dec = _temporal_geometry(scalefac, n_chan_layers[0])
        _add_encoder(self, n_chan_input, n_bins_in, enc, pool=(2, 3))
        self._add_level_attention(
            self_attn_depth, self_attn_number,
            dict.fromkeys((1, 2, 3, 4, 5), embed_dim),
            lambda dim, letter: TransformerTemporalEncLayer(
                dim, num_heads, mlp_dim, p_dropout,
                pos_encoding=pos_encoding if letter == "a" else None,
                attn_mode=attn_mode))
        c = _add_decoder(self, enc, dec)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)


class UNetTemporalBlstmVarLayers(UNetBlstmVarLayers):
    """Reference ``u_net_temporal_blstm_varlayers``
    (unet_cnns.py:1258-1364): the BLSTM version of the temporal U-Net."""

    geometry = staticmethod(_temporal_geometry)
    pool = upsamp = (2, 3)


class SimpleUNetDoubleSelfAttnTransEnc(_SimpleUNet):
    """Reference ``simple_u_net_doubleselfattn_transenc``
    (unet_cnns.py:1370-1526): varlayers-style skip attention without a
    positional encoding, then a transformer time reduction in place of
    the head's conv3/conv4. After the head's ``conv2`` (binning to the
    pitches), the map's channel and frequency axes swap, two temporal
    layers ``attention_time1`` (with ``pos_encoding``) and
    ``attention_time2`` run over its time steps (so ``time_embed_dim``
    must be ``72 · n_chan_layers[1]``), the axes swap back, the centre is
    cropped by 37 frames each side and the 1x1 ``reduction`` (conv and
    sigmoid) gives ``(B, 1, T-74, 72)``: the reference's intent, where its
    stray ``unsqueeze(1)`` returns 5-D (:1525)."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 8, embed_dim: int = 64, num_heads: int = 8,
                 mlp_dim: int = 512, self_attn_depth: int = 0,
                 self_attn_number: int = 2, time_embed_dim: int = 256,
                 pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch"):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _add_encoder(self, n_chan_input, n_bins_in, enc)
        self._add_level_attention(
            self_attn_depth, self_attn_number, _level_dims(embed_dim),
            lambda dim, letter: TransformerEncLayer(
                dim, num_heads, mlp_dim, p_dropout, attn_mode=attn_mode))
        c = _add_decoder(self, enc, dec)
        self.conv2 = ConvBlock(c, n_chan_layers[1], (3, 3), stride=(1, 3),
                               padding=(1, 0), a_lrelu=a_lrelu,
                               p_dropout=p_dropout, pool_kernel=(13, 1),
                               pool_stride=(1, 1), pool_padding=(6, 0))
        for name, pe in (("attention_time1", pos_encoding),
                         ("attention_time2", None)):
            setattr(self, name, TransformerTemporalEncLayer(
                time_embed_dim, num_heads, mlp_dim, p_dropout,
                pos_encoding=pe, attn_mode=attn_mode))
        self.reduction = nn.Sequential(
            Conv2d(n_chan_layers[1], 1, (1, 1)), nn.Sigmoid())

    def _head(self, h):
        h = self.conv2(h).transpose(1, 3)               # (B, F, T, C)
        h = self.attention_time2(self.attention_time1(h)).transpose(1, 3)
        half = 75 // 2
        return self.reduction(h[:, :, half:h.shape[2] - half])


# -- the frequency U-Nets: pooled over frequency only, unpooled by index ---

def _bn_conv_selu(in_channels, features, kernel, padding):
    """The reference's ``Sequential(BatchNorm2d, Conv2d, SELU)``
    (unet_cnns.py:1715-1726): BN at ``.0``, the conv at ``.1``."""
    return nn.Sequential(nn.BatchNorm2d(in_channels, eps=1e-5, momentum=0.1),
                         Conv2d(in_channels, features, kernel,
                                padding=padding), nn.SELU())


class FreqUNet(nn.Module):
    """Reference ``freq_u_net`` (unet_cnns.py:1539-1603): SELU convs, the
    maps max-pooled over frequency only (by 3, 4 and 6) and unpooled by
    the pools' indices, then the pitch head. The reference class cannot
    be built (``single_conv_SELU`` is undefined, :1558), so it has no
    ``state_dict`` names: the modules carry the JAX package's names
    (``down_conv1.0`` .. ``down_conv3.0``, ``up_conv3.0`` ..
    ``up_conv1.0``; the head ``conv2``..``conv4`` as everywhere)."""

    pools = (3, 4, 6)

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (32, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 1):
        super().__init__()
        sc, n_ch = scalefac, n_chan_layers
        c1, c2, c3 = 32 // sc, 64 // sc, 128 // sc
        self.a_lrelu = a_lrelu
        self.layernorm = HarmonicLayerNorm(n_chan_input, n_bins_in)
        self.down_conv1 = SingleConvSELU(n_chan_input, c1, (5, 5), (2, 2))
        self.down_conv2 = SingleConvSELU(c1, c2, (5, 5), (2, 2))
        self.down_conv3 = SingleConvSELU(c2, c3, (3, 3), (1, 1))
        self.up_conv3 = SingleConvSELU(c3, c2, (3, 3), (1, 1))
        self.up_conv2 = SingleConvSELU(c2, c1, (5, 5), (2, 2))
        self.up_conv1 = SingleConvSELU(c1, n_ch[0] // sc, (5, 5), (2, 2))
        PitchHead(n_ch[0] // sc, n_ch, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)

    def _down(self, x):
        """The pooled bottleneck and the three pools' indices."""
        h, idx = self.layernorm(x), []
        for conv, k in zip((self.down_conv1, self.down_conv2,
                            self.down_conv3), self.pools):
            h, i = max_pool_with_indices_freq(conv(h), k)
            idx.append(i)
        return h, idx

    def _up(self, h, idx):
        for conv, k, i in zip((self.up_conv3, self.up_conv2, self.up_conv1),
                              self.pools[::-1], idx[::-1]):
            h = conv(max_unpool_freq(h, i, k))
        return h

    def forward(self, x):
        h, idx = self._down(x)
        return self.conv4(self.conv3(self.conv2(self._up(h, idx))))


class FreqUNetBottomStack(FreqUNet):
    """Reference ``freq_u_net_bottomstack`` (unet_cnns.py:1609-1684,
    unbuildable upstream like :class:`FreqUNet`, so named as
    :class:`FreqUNet` is): a non-pitch activity row off the pooled
    bottleneck (``bottom``: a (3, 3) SELU conv to one channel and one
    bin), time-reduced by the (75, 1) conv ``conv3b``, LeakyReLU and
    sigmoid, concatenated after the pitch bins: ``(B, 1, T-74,
    n_bins_out + 1)``."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (32, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 1):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac)
        self.bottom = SingleConvSELU(128 // scalefac, 1, (3, 3), (1, 0))
        self.conv3b = Conv2d(1, 1, (75, 1))

    def forward(self, x):
        h, idx = self._down(x)
        head = self.conv4(self.conv3(self.conv2(self._up(h, idx))))
        bm = torch.sigmoid(leaky_relu(self.conv3b(self.bottom(h)),
                                      self.a_lrelu))
        return torch.cat([head, bm], dim=3)


class FreqUNetSelfAttn(nn.Module):
    """Reference ``freq_u_net_selfattn`` (unet_cnns.py:1691-1813): the
    frequency U-Net pooled by 3, 8 and 9 (216 -> 1 bin), its convs after
    the first BN-conv-SELU (``conv2.0`` BN, ``conv2.1`` conv), and an
    inline post-norm attention block over the bottleneck's time steps
    (C tokens features projected to ``embed_dim`` for Q/K/V and back).
    The block's modules sit at the model's top level under the
    reference's names: ``q_linear``, ``k_linear``, ``v_linear``,
    ``attn``, ``o_linear``, ``layernorm5``, ``mlp6`` (linears at ``.0``
    and ``.2``) and ``layernorm6``; the pitch head is ``conv4``, ``conv5``
    and ``conv6``."""

    pools = (3, 8, 9)
    blocks = (("", 5, 6),)                  # (suffix, layernorm ids)

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (32, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 72,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 1, embed_dim: int = 64, num_heads: int = 8,
                 mlp_dim: int = 512, attn_mode: str = "cross_batch"):
        super().__init__()
        sc, n_ch = scalefac, n_chan_layers
        c1, c2, c3 = int(32 / sc), int(64 / sc), int(128 / sc)
        self.layernorm = HarmonicLayerNorm(n_chan_input, n_bins_in)
        self.conv1 = SingleConvSELU(n_chan_input, c1, (5, 5), (2, 2))
        self.conv2 = _bn_conv_selu(c1, c2, (5, 5), (2, 2))
        self.conv3 = _bn_conv_selu(c2, c3, (3, 3), (1, 1))
        for s, i, j in self.blocks:
            for name in ("q", "k", "v"):
                setattr(self, f"{name}_linear{s}",
                        nn.Linear(c3, embed_dim, bias=False))
            setattr(self, f"attn{s}", TorchMultiheadAttention(
                embed_dim, num_heads, mode=attn_mode))
            setattr(self, f"o_linear{s}", nn.Linear(embed_dim, c3,
                                                    bias=False))
            setattr(self, f"layernorm{i}", nn.LayerNorm(c3, eps=1e-5))
            setattr(self, f"mlp{j}", nn.Sequential(
                nn.Linear(c3, mlp_dim), nn.ReLU(), nn.Linear(mlp_dim, c3)))
            setattr(self, f"layernorm{j}", nn.LayerNorm(c3, eps=1e-5))
        self.dropout = nn.Dropout(p_dropout)
        self.up_conv3 = _bn_conv_selu(c3, c2, (3, 3), (1, 1))
        self.up_conv2 = _bn_conv_selu(c2, c1, (5, 5), (2, 2))
        self.up_conv1 = _bn_conv_selu(c1, int(n_ch[0] / sc), (5, 5), (2, 2))
        head = pitch_head(int(n_ch[0] / sc), n_ch, n_bins_in, n_bins_out,
                          a_lrelu, p_dropout)
        self.conv4, self.conv5, self.conv6 = (head["conv2"], head["conv3"],
                                              head["conv4"])

    def _attend(self, tokens, s, i, j):
        """One inline block on (B, T, C) tokens."""
        a = getattr(self, f"attn{s}")(
            *(getattr(self, f"{n}_linear{s}")(tokens) for n in "qkv"))
        a = self.dropout(getattr(self, f"o_linear{s}")(a))
        h = getattr(self, f"layernorm{i}")(tokens + a)
        m = self.dropout(getattr(self, f"mlp{j}")(h))
        return getattr(self, f"layernorm{j}")(h + m)

    def forward(self, x):
        h, idx = self.layernorm(x), []
        for conv, k in zip((self.conv1, self.conv2, self.conv3), self.pools):
            h, i = max_pool_with_indices_freq(conv(h), k)
            idx.append(i)
        tokens = h[..., 0].transpose(1, 2)              # (B, T, C)
        for block in self.blocks:
            tokens = self._attend(tokens, *block)
        h = tokens.transpose(1, 2)[..., None]
        for conv, k, i in zip((self.up_conv3, self.up_conv2, self.up_conv1),
                              self.pools[::-1], idx[::-1]):
            h = conv(max_unpool_freq(h, i, k))
        return self.conv6(self.conv5(self.conv4(h)))


class FreqUNetDoubleSelfAttn(FreqUNetSelfAttn):
    """Reference ``freq_u_net_doubleselfattn`` (unet_cnns.py:1820-1970):
    two inline attention blocks at the bottleneck, the second's modules
    ``q_linear2`` .. ``attn2`` .. ``layernorm7``, ``mlp8``,
    ``layernorm8``."""

    blocks = (("", 5, 6), ("2", 7, 8))


# -- the polyphony (multi-task) U-Nets -------------------------------------

class _PolyphonySAUnet(_SimpleUNet):
    """The SAUnet and a degree-of-polyphony head ``convP``
    (``layers.polyphony_head``, ReLU out) on the output of the first
    attention layer, with ``embed_dim // poly_div`` mid channels and
    ``poly_steps`` outputs. Returns ``(salience, polyphony)``."""

    def __init__(self, n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                 a_lrelu, p_dropout, scalefac, embed_dim, num_heads, mlp_dim,
                 pos_encoding, attn_mode, poly_div, poly_steps):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _check_embed_dim(embed_dim, enc)
        _add_encoder(self, n_chan_input, n_bins_in, enc)
        self.attention1 = TransformerEncLayer(
            embed_dim, num_heads, mlp_dim, pos_encoding=pos_encoding,
            attn_mode=attn_mode)
        self.attention2 = TransformerEncLayer(embed_dim, num_heads, mlp_dim,
                                              attn_mode=attn_mode)
        c = _add_decoder(self, enc, dec)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)
        self.convP = polyphony_head(embed_dim, embed_dim // poly_div,
                                    poly_steps, a_lrelu, p_dropout)

    def forward(self, x):
        skips = self._encoder(x)
        inner = self.attention1(skips[4])
        skips[4] = self.attention2(inner)
        return self._head(self._decoder(skips)), self.convP(inner)


class SimpleUNetDoubleSelfAttnPolyphony(_PolyphonySAUnet):
    """Reference ``simple_u_net_doubleselfattn_polyphony``
    (unet_cnns.py:1977-2066): the SAUnet and a degree-of-polyphony
    regression head ``convP`` on the output of the first attention layer
    (``embed_dim // 4`` mid channels, one output, ReLU). Returns
    ``(salience, polyphony)``, the second ``(B, 1, Tb-3, F')``."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, embed_dim: int = 32, num_heads: int = 8,
                 mlp_dim: int = 512, pos_encoding: Optional[str] = None,
                 attn_mode: str = "cross_batch"):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac, embed_dim, num_heads,
                         mlp_dim, pos_encoding, attn_mode, 4, 1)


class SimpleUNetDoubleSelfAttnPolyphonyClassif(_PolyphonySAUnet):
    """Reference ``simple_u_net_doubleselfattn_polyphony_classif``
    (unet_cnns.py:2070-2159): polyphony as a ``num_polyphony_steps``-way
    classification, ``embed_dim // 2`` mid channels, ReLU logits."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, embed_dim: int = 32, num_heads: int = 8,
                 mlp_dim: int = 512, pos_encoding: Optional[str] = None,
                 num_polyphony_steps: int = 24,
                 attn_mode: str = "cross_batch"):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac, embed_dim, num_heads,
                         mlp_dim, pos_encoding, attn_mode, 2,
                         num_polyphony_steps)


class SimpleUNetPolyphonyClassif(SimpleUNetLargeKernels):
    """Reference ``simple_u_net_polyphony_classif`` (unet_cnns.py:
    2163-2247): the Unet with a polyphony classification head ``convP``
    off the raw bottleneck x5 (``1024 / (4·scalefac)`` mid channels, ReLU
    logits). Returns ``(salience, polyphony logits)``."""

    relu_out = True

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, num_polyphony_steps: int = 24):
        super().__init__(n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                         a_lrelu, p_dropout, scalefac)
        self.convP = polyphony_head(
            1024 // (scalefac * 2), 1024 // (scalefac * 4),
            num_polyphony_steps, a_lrelu, p_dropout, self.relu_out)

    def forward(self, x):
        skips = self._encoder(x)
        return self._head(self._decoder(skips)), self.convP(skips[4])


class SimpleUNetPolyphonyClassifSoftmax(SimpleUNetPolyphonyClassif):
    """Reference ``simple_u_net_polyphony_classif_softmax``
    (unet_cnns.py:2251-2335), the paper's PUnet M/L/XL (exp195*): as
    :class:`SimpleUNetPolyphonyClassif` with raw logits (the softmax lies
    in the cross-entropy loss). Returns ``(salience, polyphony logits)``:
    ``(B, 1, T-74, 72)`` and ``(B, steps, Tb-3, F')``."""

    relu_out = False
