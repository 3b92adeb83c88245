"""Exact cross-window sharing of the U-Net ``inc`` layer's interior.

Counterpart of ``multipitch_architectures_tpu/eval/shared_inc.py``.

The windowed protocol (stride-1 75-frame windows, exp180d…py:427-443)
recomputes every layer per window. Below ``down1`` each window's zero
padding reaches every output row, but the FIRST block (``inc``: the
harmonic LayerNorm and a DoubleConv, no pooling) is time-invariant in
its interior: output row ``r`` of a window centred at frame ``c``
depends only on frames ``c-37+r-14 .. c-37+r+14`` (two 15-frame convs),
which for rows 14..60 never touch the window's padding. Those 47 of 75
rows are the same in every window that holds them, and equal to one
dense pass over the padded recording.

:class:`SharedIncForward` computes the dense LayerNorm and ``inc`` once
per recording (:meth:`~SharedIncForward.precompute`), then for each
dispatch (:meth:`~SharedIncForward.assemble`) gathers the interior rows
from it and recomputes only the 2 x 14 edge rows, with the window's own
zero padding on the outer side and real frames on the inner side. The
rest of the model runs on a shallow copy whose ``layernorm`` and ``inc``
are ``nn.Identity``, fed the assembled ``inc`` output (the counterpart of
the JAX package's flax interceptor). With the int8 serving mode
(``eval/quant.py``) the copy's downstream convs are quantized while the
shared ``inc`` stays float32.

It takes every model whose first block is the plain DoubleConv ``inc``:
SAUnet, Unet, SAUSnet, BLUnet and PUnet. ``residual`` shortcuts live in
the down and up blocks only and run unchanged. A model with an
``alt_order`` or residual ``inc``, or without an ``inc`` (the CNN
family), raises ``ValueError``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import DoubleConv, HarmonicLayerNorm
from .inference import _check_eval, _first, _next_batch_size, _pad_inputs
from .quant import _replaced, quantize_convs


def _check_plain_inc(model):
    inc = getattr(model, "inc", None)
    if not isinstance(inc, DoubleConv) or \
            not isinstance(getattr(model, "layernorm", None),
                           HarmonicLayerNorm):
        raise ValueError(f"shared-inc wants a U-Net whose first blocks are "
                         f"the harmonic LayerNorm and a DoubleConv inc; "
                         f"{type(model).__name__} has none")
    if getattr(model, "alt_order", False):
        raise ValueError("shared-inc supports the plain DoubleConv inc "
                         "branch only (alt_order changes inc)")
    if inc.resize is not None:
        raise ValueError("shared-inc does not support inc_residual")


class SharedIncForward:
    """Windowed forward with the ``inc`` interior shared across windows.

    Per recording::

        fwd = SharedIncForward(model)             # or with int8 scales
        ln_dense, inc_dense = fwd.precompute(xp)
        y = fwd.forward(ln_dense, inc_dense, centers)

    ``xp`` is the compressed, (half, half + 1)-padded HCQT ``(6, T_pad,
    n_bins)`` and ``centers`` are window-centre indices into ``xp`` (as
    in ``eval/inference.py``). ``model`` is in eval mode; every tensor
    lies on its device.

    Args:
        min_kernel_elems, activation_scales, int8: the int8 serving mode
            (``eval/quant.py``) for the downstream convs: with ``int8`` or
            ``activation_scales``, the rest of the model runs through
            ``quantize_convs``. The shared ``inc`` stays float32.
    """

    def __init__(self, model, context: int = 75, min_kernel_elems=4096,
                 activation_scales=None, int8: bool = False):
        _check_plain_inc(model)
        _check_eval(model, "SharedIncForward")
        self.model = model
        self.context = context
        self.layernorm, self.inc = model.layernorm, model.inc
        convs = [m for m in self.inc.double_conv if isinstance(m, nn.Conv2d)]
        self.pad = convs[0].padding[0]
        if any(c.kernel_size[0] != 2 * self.pad + 1 or c.stride != (1, 1)
               or c.padding != convs[0].padding for c in convs):
            raise ValueError("shared-inc wants inc's convs 'same'-padded, "
                             "stride 1, of one kernel size")
        self.edge = 2 * self.pad                       # edge rows per side
        if context <= 2 * self.edge:
            raise ValueError("context too small for a shared-inc interior")
        rest = _replaced(model, {"layernorm": nn.Identity(),
                                 "inc": nn.Identity()})
        if int8 or activation_scales is not None:
            rest = quantize_convs(rest, min_kernel_elems, activation_scales)
        self.rest = rest

    # -- per-recording dense pass ------------------------------------------

    @torch.no_grad()
    def precompute(self, xp):
        """Dense LayerNorm and ``inc`` over the padded recording ``xp``
        (6, T_pad, F), NCHW: returns ``(ln_dense (1, 6, T_pad, F),
        inc_dense (1, C, T_pad, F))``."""
        ln = self.layernorm(xp[None])
        return ln, self.inc(ln)

    # -- per-dispatch assembled forward ------------------------------------

    def _edge(self, x, time_pad):
        """``inc`` on a slab of edge rows: each conv zero-pads time by
        ``time_pad`` (outer side only) and frequency by its own padding,
        then runs unpadded; BatchNorm, ReLU and dropout (eval) as the
        block's own layers, in its order."""
        for layer in self.inc.double_conv:
            if isinstance(layer, nn.Conv2d):
                pw = layer.padding[1]
                x = F.conv2d(F.pad(x, (pw, pw) + time_pad), layer.weight,
                             layer.bias)
            else:
                x = layer(x)
        return x

    @staticmethod
    def _slab(src, starts, rows):
        """(n, C, rows, F): rows ``starts[i] .. starts[i] + rows - 1`` of
        ``src`` (1, C, T, F) for each window."""
        idx = starts[:, None] + torch.arange(rows, device=src.device)
        return src[0][:, idx].transpose(0, 1)

    @torch.no_grad()
    def assemble(self, ln_dense, inc_dense, centers):
        """The ``inc`` output of the windows centred at ``centers``
        (indices into the padded recording): (n, C, context, F), the
        top and bottom ``edge`` rows recomputed from ``ln_dense``, the
        interior gathered from ``inc_dense``."""
        half, e, p = self.context // 2, self.edge, self.pad
        centers = torch.as_tensor(np.asarray(centers),
                                  device=ln_dense.device)
        top = self._edge(self._slab(ln_dense, centers - half, 4 * p),
                         (p, 0))
        bottom = self._edge(self._slab(ln_dense, centers + half - (4 * p - 1),
                                       4 * p), (0, p))
        interior = self._slab(inc_dense, centers - half + e,
                              self.context - 2 * e)
        return torch.cat([top, interior, bottom], dim=2)

    @torch.no_grad()
    def forward(self, ln_dense, inc_dense, centers, with_aux=False):
        """(n, bins) predictions of the windows centred at ``centers``;
        with ``with_aux`` also the second output flattened per window
        ((n, 0) for a model without one)."""
        y = self.rest(self.assemble(ln_dense, inc_dense, centers))
        n = len(centers)
        main = _first(y).reshape(n, -1)
        if not with_aux:
            return main
        aux = y[1].reshape(n, -1) if isinstance(y, tuple) \
            else main.new_zeros((n, 0))
        return main, aux


def predict_framewise_shared(model, inputs, context=75, batch_size=50,
                             compression=10.0, group=None,
                             min_kernel_elems=4096, activation_scales=None,
                             int8=False, return_aux=False):
    """``eval.predict_framewise`` with the shared-``inc`` forward: the
    same protocol batching (full batches, the grouped tail's full groups,
    the natural-size remainder), about 6 % less work per window. Its
    output is float-reassociation-close to ``predict_framewise``; the
    int8 arguments give the quantized serving mode with ``inc`` in
    float32 (:class:`SharedIncForward`). One dense ``inc`` map per call:
    (C, T + context, F) float32, 1.43 GB for a 20-min recording of
    exp180e.

    Returns: (T, bins) float32 tensor on ``inputs``' device, or
    ``(pred, aux)`` with ``return_aux``.
    """
    if group is not None and batch_size % group:
        raise ValueError(f"batch_size {batch_size} not a multiple of "
                         f"attention group {group}")
    fwd = SharedIncForward(model, context, min_kernel_elems,
                           activation_scales, int8=int8)
    x = torch.as_tensor(inputs, dtype=torch.float32)
    if compression is not None:
        x = torch.log1p(compression * x)
    t = x.shape[1]
    ln_dense, inc_dense = fwd.precompute(_pad_inputs(x, context))
    half = context // 2
    outs, auxs = [], []
    start = 0
    while start < t:
        n = _next_batch_size(t - start, batch_size, group)
        y = fwd.forward(ln_dense, inc_dense, half + start + np.arange(n),
                        with_aux=return_aux)
        if return_aux:
            y, aux = y
            auxs.append(aux)
        outs.append(y)
        start += n
    if return_aux:
        return torch.cat(outs), torch.cat(auxs)
    return torch.cat(outs)
