"""Operations and bytes of the int8 serving mode (``reference/quant.py``),
from the shapes of the configuration's plain reference.

A forward of one window on the meta device records each W8A8
convolution's input and output shapes. For a batch of ``B`` windows,
each such convolution (Cin -> Cout, kh x kw, output Ho x Wo) counts

- int8 operations: 2·B·Cout·Ho·Wo·Cin·kh·kw, each multiply and add once;
- bytes, each read or written once: the int8 activation (B·Cin·H·W), the
  int8 weights (Cout·Cin·kh·kw), the float32 output (4·B·Cout·Ho·Wo),
  and the float32 weight scales, activation scale and bias
  (4·Cout + 4 + 4·Cout).

The rest of the forward stays float32: the configuration's counts
(``forward_flops``) less these operations.
"""

import torch

from .. import common
from ..reference.quant import eligible


def convs(cfg, root=common.ROOT):
    """[(int8 operations per window, bytes per window, bytes per
    launch)] of each W8A8 convolution of configuration ``cfg``."""
    fe, m = cfg["frontend"], cfg["quant"]["min_kernel_elems"]
    shapes = []
    with torch.device("meta"):
        ref = common.reference(cfg, root).eval()
        handles = [conv.register_forward_hook(
            lambda mod, args, out: shapes.append(
                (mod, args[0].shape, out.shape)))
            for _, conv in eligible(ref, m)]
        x = torch.zeros(1, fe["num_harmonics"] + fe["num_subharmonics"],
                        fe["context"],
                        fe["bins_per_octave"] * fe["num_octaves"])
        with torch.no_grad():
            ref(x)
    for h in handles:
        h.remove()
    out = []
    for mod, (_, cin, h, w), (_, cout, ho, wo) in shapes:
        k = mod.weight[0].numel()
        out.append((2 * cout * ho * wo * k,
                    cin * h * w + 4 * cout * ho * wo,
                    mod.weight.numel() + 4 * cout + 4
                    + (4 * cout if mod.bias is not None else 0)))
    return out


def least_seconds(costs, batch):
    """The int8 GEMM's least time for one batch of ``batch`` windows: each
    launch's operations at the int8 peak or its bytes at HBM's rate,
    whichever is longer."""
    ops_rate, byte_rate = (common.PEAKS["int8_op_per_s"],
                           common.PEAKS["hbm_bytes_per_s"])
    return sum(max(ops * batch / ops_rate,
                   (nbytes * batch + fixed) / byte_rate)
               for ops, nbytes, fixed in costs)
