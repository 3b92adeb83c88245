"""The U-Net family of the model zoo.

Counterpart of the JAX package's ``models/unets.py``, so far for the five
classes that the experiment registry uses: the paper's Unet, SAUnet,
SAUSnet, BLUnet and PUnet. NCHW ``(B, harmonics, T, F)`` in,
``(B, 1, T-74, 72)`` out: ``(B, 1, 1, 72)`` for one 75-frame window (the
PUnet adds its polyphony logits).
"""

from typing import Optional, Sequence

from torch import nn

from ..ops.resize import up_concat_pad
from .layers import (BLSTMTemporalEncLayer, DoubleConv, HarmonicLayerNorm,
                     PitchHead, TransformerEncLayer)


def _std_geometry(sc: int, n_ch0: int, kernels=(15, 9, 5, 3)):
    """Channel and kernel ladder of the standard simple_u_net family
    (unet_cnns.py:347-369): encoder widths 64..1024 / scalefac, decoder
    mirrored."""
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


def _pad(k):
    return (k[0] // 2, k[1] // 2)


def _block(c_in, g, convdrop=0.0, residual=False):
    return DoubleConv(c_in, g["out"], g["mid"], g["k"], _pad(g["k"]),
                      convdrop=convdrop, residual=residual)


def _add_encoder(model, n_chan_input, n_bins_in, enc, convdrop=0.0,
                 residual=False):
    """``layernorm``, ``inc`` and ``down1``..``down4`` (each the
    reference's Sequential of a 2x2 max-pool and a DoubleConv).
    ``residual`` applies to the down blocks only, as in the reference."""
    model.layernorm = HarmonicLayerNorm(n_chan_input, n_bins_in)
    model.inc = _block(n_chan_input, enc[0], convdrop)
    for i in range(1, 5):
        setattr(model, f"down{i}", nn.Sequential(
            nn.MaxPool2d((2, 2)),
            _block(enc[i - 1]["out"], enc[i], convdrop, residual)))


def _add_decoder(model, enc, dec, convdrop=0.0, residual=False,
                 widths=None):
    """``upconv1``..``upconv4``. ``widths`` are the channels of
    [x5, x4, x3, x2, x1] as the decoder meets them (the encoder's by
    default). Returns the decoder's output width."""
    widths = widths or [g["out"] for g in enc[::-1]]
    c = widths[0]
    for i in range(1, 5):
        setattr(model, f"upconv{i}", _block(c + widths[i], dec[i - 1],
                                            convdrop, residual))
        c = dec[i - 1]["out"]
    return c


def _encode(x, inc, downs):
    """inc, then down1..down4 (each a 2x2 max-pool and a DoubleConv).
    Returns the five maps [x1, .., x5]."""
    skips = [inc(x)]
    for down in downs:
        skips.append(down(skips[-1]))
    return skips


def _decode(x, skips, upconvs, upsamp=(2, 2)):
    """Up-concat with each of ``skips = [x4, x3, x2, x1]``, each followed
    by its DoubleConv."""
    for skip, upconv in zip(skips, upconvs):
        x = upconv(up_concat_pad(x, skip, upsamp))
    return x


class _SimpleUNet(nn.Module):
    """Forward helpers of the simple_u_net classes."""

    def _encoder(self, x):
        return _encode(self.layernorm(x), self.inc,
                       [self.down1, self.down2, self.down3, self.down4])

    def _decoder(self, x5, skips):
        return _decode(x5, skips, [self.upconv1, self.upconv2, self.upconv3,
                                   self.upconv4])

    def _head(self, h):
        return self.conv4(self.conv3(self.conv2(h)))


def _check_embed_dim(embed_dim, enc):
    if enc[4]["out"] != embed_dim:
        raise ValueError(f"embed_dim {embed_dim} must equal the "
                         f"bottleneck width {enc[4]['out']}")


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

    def forward(self, x):
        x1, x2, x3, x4, x5 = self._encoder(x)
        return self._head(self._decoder(x5, [x4, x3, x2, x1]))


class SimpleUNetDoubleSelfAttn(_SimpleUNet):
    """Reference ``simple_u_net_doubleselfattn`` (unet_cnns.py:496-575),
    the paper's SAUnet: two transformer encoder layers at the bottleneck,
    the first with the positional encoding, the second without.

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
                 attn_mode: str = "cross_batch"):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _check_embed_dim(embed_dim, enc)
        _add_encoder(self, n_chan_input, n_bins_in, enc, convdrop, residual)
        for name, pe in (("attention1", pos_encoding), ("attention2", None)):
            setattr(self, name, TransformerEncLayer(
                embed_dim, num_heads, mlp_dim, pos_encoding=pe,
                attn_mode=attn_mode))
        c = _add_decoder(self, enc, dec, convdrop, residual)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)

    def forward(self, x):
        x1, x2, x3, x4, x5 = self._encoder(x)
        x5 = self.attention2(self.attention1(x5))
        return self._head(self._decoder(x5, [x4, x3, x2, x1]))


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
        c = _add_decoder(self, enc, dec, convdrop, residual)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)

    def forward(self, x):
        x1, x2, x3, x4, x5 = self._encoder(x)
        x5 = self.attention2(self.attention1(x5))
        x4 = self.attention4(self.attention3(x4))
        return self._head(self._decoder(x5, [x4, x3, x2, x1]))


class UNetBlstmVarLayers(_SimpleUNet):
    """Reference ``u_net_blstm_varlayers`` (unet_cnns.py:1000-1101), the
    paper's BLUnet M/L/XXL (exp186*): a BLSTM stack ``lstm{level}``
    (``lstm_number`` layers) on each of the ``lstm_depth`` deepest levels,
    5 first. Each level's map is processed just before the decoder meets
    it. A processed level has ``2 * hidden_size / F`` channels, F being
    its frequency bins (13 at level 5 of a 216-bin input). ``embed_dim``
    is the reference's argument, its bottleneck's C·F; the LSTM's width
    follows the map, as in the JAX package."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 8, embed_dim: int = 64,
                 hidden_size: int = 512, lstm_depth: int = 0,
                 lstm_number: int = 2):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _add_encoder(self, n_chan_input, n_bins_in, enc)
        widths = [g["out"] for g in enc[::-1]]          # x5, x4, .., x1
        self.levels = [lv for lv in (5, 4, 3, 2, 1) if lstm_depth >= 6 - lv]
        for level in self.levels:
            n_bins = n_bins_in // 2 ** (level - 1)
            setattr(self, f"lstm{level}", BLSTMTemporalEncLayer(
                widths[5 - level], n_bins, hidden_size, lstm_number))
            widths[5 - level] = 2 * hidden_size // n_bins
        c = _add_decoder(self, enc, dec, widths=widths)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)

    def _process(self, h, level):
        return getattr(self, f"lstm{level}")(h) if level in self.levels \
            else h

    def forward(self, x):
        skips = self._encoder(x)                        # x1 .. x5
        h = self._process(skips[4], 5)
        upconvs = [self.upconv1, self.upconv2, self.upconv3, self.upconv4]
        for level, upconv in zip((4, 3, 2, 1), upconvs):
            h = upconv(up_concat_pad(h, self._process(skips[level - 1],
                                                      level)))
        return self._head(h)


class SimpleUNetPolyphonyClassifSoftmax(_SimpleUNet):
    """Reference ``simple_u_net_polyphony_classif_softmax``
    (unet_cnns.py:2251-2335), the paper's PUnet M/L/XL (exp195*): the
    Unet with a degree-of-polyphony head ``convP`` on the bottleneck
    (unet_cnns.py:2311-2318): conv (2, 5) -> LeakyReLU -> max-pool (2, 5)
    stride (1, 2) -> dropout -> conv (2, 3), all unpadded, raw logits (the
    softmax lies in the cross-entropy loss). On the 4 x 13 bottleneck of a
    window it gives 1 x 1. Returns ``(salience, polyphony logits)``:
    ``(B, 1, T-74, 72)`` and ``(B, steps, Tb-3, F')``."""

    def __init__(self, n_chan_input: int = 6,
                 n_chan_layers: Sequence[int] = (64, 30, 20, 10),
                 n_bins_in: int = 216, n_bins_out: int = 12,
                 a_lrelu: float = 0.3, p_dropout: float = 0.2,
                 scalefac: int = 16, num_polyphony_steps: int = 24):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        _add_encoder(self, n_chan_input, n_bins_in, enc)
        c = _add_decoder(self, enc, dec)
        PitchHead(c, n_chan_layers, n_bins_in, n_bins_out, a_lrelu,
                  p_dropout).attach(self)
        mid = 1024 // (scalefac * 4)
        self.convP = nn.Sequential(
            nn.Conv2d(enc[4]["out"], mid, (2, 5)), nn.LeakyReLU(a_lrelu),
            nn.MaxPool2d((2, 5), (1, 2)), nn.Dropout(p_dropout),
            nn.Conv2d(mid, num_polyphony_steps, (2, 3)))

    def forward(self, x):
        x1, x2, x3, x4, x5 = self._encoder(x)
        y = self._head(self._decoder(x5, [x4, x3, x2, x1]))
        return y, self.convP(x5)
