"""FLOPs of DCNN and DRCNN (``deep_cnn_segm_sigmoid``), from their widths.

Counted as ``torch.utils.flop_counter.FlopCounterMode`` counts them over
the plain reference (``portbench/reference/drcnn.py``): two FLOPs per
multiply-add of every convolution, and nothing for the LayerNorm, the
activations, the max-pools, the dropout or the identity shortcuts.

Forward, for a batch of ``B`` windows of ``T = context`` frames and
``F`` bins (216), widths ``n = n_chan_layers``:

- the first prefilter convolution, 6 -> n[0], 15 x 15 at (T, F):
  2·B·T·F·225·6·n[0];
- each of the ``n_prefilt_layers - 1`` others, n[0] -> n[0], 15 x 15 at
  (T, F): 2·B·T·F·225·n[0]² (DRCNN's four at 70 channels are 97.6 % of
  its forward);
- the head: a 3 x 3 conv of stride (1, 3) to (T, F//3), a (T, 1) conv
  to one frame, a 1 x 1 conv and a (1, F//3 + 1 - 72) conv.

A training step is three times the forward: the backward computes, for
every convolution, the gradient of its input and of its weight, each as
many FLOPs as the forward (the first convolution's input is the
LayerNorm's output, which needs a gradient).
"""


def forward_flops(args, batch, group=None, context=75):
    """FLOPs of one forward of ``batch`` windows (``group`` is not used:
    no operation mixes the windows of a batch)."""
    n, f = args["n_chan_layers"], args["n_bins_in"]
    plane = batch * context * f * 15 * 15
    flops = 2 * plane * args["n_chan_input"] * n[0]
    flops += 2 * plane * n[0] * n[0] * (args["n_prefilt_layers"] - 1)
    w_out = (f - 3) // 3 + 1
    last = f // 3 + 1 - args["n_bins_out"]
    flops += 2 * batch * context * w_out * 9 * n[0] * n[1]
    flops += 2 * batch * w_out * context * n[1] * n[2]
    flops += 2 * batch * w_out * n[2] * n[3]
    flops += 2 * batch * args["n_bins_out"] * last * n[3]
    return flops


def train_step_flops(args, batch, context=75):
    """FLOPs of one training step (forward and backward) at ``batch``."""
    return 3 * forward_flops(args, batch, None, context)
