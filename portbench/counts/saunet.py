"""FLOPs of SAUnet (``simple_u_net_doubleselfattn``), from its widths.

Counted as ``torch.utils.flop_counter.FlopCounterMode`` counts them over
the plain reference (``portbench/reference/saunet.py``): two FLOPs per
multiply-add of every convolution, linear and batched product, and
nothing for normalisation, activations, pooling, softmax or the bilinear
upsampling. Each operation is counted once, whatever the program does
in its place (the port's upsampling as two products, its split-TF32
kernels, cuDNN's algorithms).

Forward, for a batch of ``B`` windows of ``T = context`` frames and
``F = 216`` bins, the encoder at (T, F), (T//2, F//2), ... (four 2 x 2
pools: 75 x 216 -> 37 x 108 -> 18 x 54 -> 9 x 27 -> 4 x 13):

- each DoubleConv (c_in -> mid -> out, k x k, padding k//2) at (h, w):
  2·B·h·w·k²·(c_in·mid + mid·out);
- each transformer layer on L = 4·13 tokens of width E (mlp width M):
  2·B·L·(8·E² + 2·E·M) for its Q/K/V, packed-input, output and MLP
  products, plus 2·2·L·B·g·E for the attention's two batched products
  over a group of ``g`` samples (``g = B`` when the batch is one group);
- the decoder's DoubleConvs at the skips' sizes, their inputs the
  skip's width plus the upsampled map's;
- the head: a 3 x 3 conv of stride (1, 3) to (T, 72), a (T, 1) conv to
  one frame, a 1 x 1 conv and a (1, 216//3 + 1 - 72) conv.

A training step is three times the forward: the backward computes, for
every product, the gradient of its input and of its weight, each as
many FLOPs as the forward (every product's input needs a gradient: the
first convolution's input is the LayerNorm's output).
"""

from ..reference.saunet import geometry


def _double_conv(b, h, w, c_in, mid, out, k):
    return 2 * b * h * w * k * k * (c_in * mid + mid * out)


def forward_flops(args, batch, group=None, context=75):
    """FLOPs of one forward of ``batch`` windows in groups of ``group``
    (the attention's; the whole batch by default)."""
    g = batch if group is None else min(group, batch)
    enc, ks, dec = geometry(args["scalefac"], args["n_chan_layers"][0])
    f_in = args["n_bins_in"]
    sizes = [(context, f_in)]
    for _ in range(4):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    flops = 0
    c = args["n_chan_input"]
    for (h, w), out, k in zip(sizes, enc, ks):
        flops += _double_conv(batch, h, w, c, out, out, k)
        c = out
    e, mlp = args["embed_dim"], args["mlp_dim"]
    tokens = sizes[4][0] * sizes[4][1]
    per_layer = 2 * batch * tokens * (8 * e * e + 2 * e * mlp) \
        + 2 * 2 * tokens * batch * g * e
    flops += 2 * per_layer
    for (out, mid, k), (h, w), skip in zip(dec, sizes[3::-1], enc[3::-1]):
        flops += _double_conv(batch, h, w, c + skip, mid, out, k)
        c = out
    n = args["n_chan_layers"]
    w_out = (f_in - 3) // 3 + 1
    last = f_in // 3 + 1 - args["n_bins_out"]
    flops += 2 * batch * context * w_out * 9 * c * n[1]
    flops += 2 * batch * w_out * context * n[1] * n[2]
    flops += 2 * batch * w_out * n[2] * n[3]
    flops += 2 * batch * args["n_bins_out"] * last * n[3]
    return flops


def train_step_flops(args, batch, context=75):
    """FLOPs of one training step (forward and backward) at ``batch``,
    the whole batch one attention group."""
    return 3 * forward_flops(args, batch, None, context)
