"""The SAUnet model (``simple_u_net_doubleselfattn``).

Counterpart of the JAX package's ``models/unets.py``, so far for the
paper's SAUnet M/L/XL/XXL (the flagship of exp180*). NCHW
``(B, harmonics, T, F)`` in, ``(B, 1, T-74, 72)`` out: ``(B, 1, 1, 72)``
for one 75-frame window.
"""

from typing import Optional, Sequence

from torch import nn

from ..ops.resize import up_concat_pad
from .layers import (DoubleConv, HarmonicLayerNorm, TransformerEncLayer,
                     pitch_head)


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


class SimpleUNetDoubleSelfAttn(nn.Module):
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
                 convdrop: Optional[float] = 0.0,
                 attn_mode: str = "cross_batch"):
        super().__init__()
        enc, dec = _std_geometry(scalefac, n_chan_layers[0])
        self.layernorm = HarmonicLayerNorm(n_chan_input, n_bins_in)

        def block(c_in, g):
            return DoubleConv(c_in, g["out"], g["mid"], g["k"], _pad(g["k"]),
                              convdrop=convdrop)

        self.inc = block(n_chan_input, enc[0])
        for i in range(1, 5):
            setattr(self, f"down{i}", nn.Sequential(
                nn.MaxPool2d((2, 2)), block(enc[i - 1]["out"], enc[i])))
        if enc[4]["out"] != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} must equal the "
                             f"bottleneck width {enc[4]['out']}")
        for name, pe in (("attention1", pos_encoding), ("attention2", None)):
            setattr(self, name, TransformerEncLayer(
                embed_dim, num_heads, mlp_dim, pos_encoding=pe,
                attn_mode=attn_mode))
        c = enc[4]["out"]
        for i in range(1, 5):
            skip = enc[4 - i]["out"]
            setattr(self, f"upconv{i}", block(c + skip, dec[i - 1]))
            c = dec[i - 1]["out"]
        for name, m in pitch_head(c, n_chan_layers, n_bins_in, n_bins_out,
                                  a_lrelu, p_dropout).items():
            self.add_module(name, m)

    def forward(self, x):
        x = self.layernorm(x)
        x1, x2, x3, x4, x5 = _encode(
            x, self.inc, [self.down1, self.down2, self.down3, self.down4])
        x5 = self.attention2(self.attention1(x5))
        h = _decode(x5, [x4, x3, x2, x1],
                    [self.upconv1, self.upconv2, self.upconv3, self.upconv4])
        return self.conv4(self.conv3(self.conv2(h)))
