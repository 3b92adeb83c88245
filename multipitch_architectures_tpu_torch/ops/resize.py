"""Bilinear upsampling with ``align_corners=True`` semantics, as matmuls,
and the U-Nets' up-concat step (NCHW).

Counterpart of ``multipitch_architectures_tpu/ops/resize.py``. The
reference's ``unet_up_concat_padding`` upsamples with
``nn.Upsample(mode='bilinear', align_corners=True)``; like the JAX
package, the port applies the interpolation as two products with
operators built in float64, so it samples at the JAX package's
positions, and its backward is two products too: deterministic on the
card, where the backward of ``F.interpolate`` adds with atomics.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-interpolation operator, align_corners=True,
    in float64."""
    w = np.zeros((n_out, n_in), dtype=np.float64)
    if n_in == 1 or n_out == 1:
        w[:, 0] = 1.0
        return w
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.minimum(np.floor(pos).astype(np.int64), n_in - 2)
    frac = pos - i0
    w[np.arange(n_out), i0] = 1.0 - frac
    w[np.arange(n_out), i0 + 1] += frac
    return w


_OPERATORS = {}


def _operator(n_in, n_out, dtype, device):
    """The interpolation operator cast to ``dtype`` on ``device``, made
    once per shape, type and device. Under ``torch.export`` it is made
    anew and not kept: a traced tensor must not reach eager calls."""
    key = (n_in, n_out, dtype, device)
    if key in _OPERATORS:
        return _OPERATORS[key]
    a = torch.from_numpy(_interp_matrix(n_in, n_out)).to(device=device,
                                                         dtype=dtype)
    if not torch.compiler.is_compiling():
        _OPERATORS[key] = a
    return a


def upsample_bilinear_align_corners(x, size):
    """Upsample NCHW ``x`` to spatial ``size=(H_out, W_out)``: time, then
    frequency, each one product with its operator. Matches
    ``torch.nn.Upsample(mode='bilinear', align_corners=True)``."""
    h_in, w_in = x.shape[2], x.shape[3]
    a_h = _operator(h_in, size[0], x.dtype, x.device)
    a_w = _operator(w_in, size[1], x.dtype, x.device)
    return torch.matmul(torch.matmul(a_h, x), a_w.T)


def up_concat_pad(x1, x2, upsamp_fac=(2, 2)):
    """Upsample ``x1`` by ``upsamp_fac`` (bilinear, align_corners=True),
    zero-pad it to ``x2``'s spatial size and concat ``[x2, x1]`` along
    channels. The pad order is the reference's: left = dW//2,
    right = dW - dW//2, top = dH//2, bottom = dH - dH//2."""
    size = (x1.shape[2] * upsamp_fac[0], x1.shape[3] * upsamp_fac[1])
    x1 = upsample_bilinear_align_corners(x1, size)
    dh, dw = x2.shape[2] - size[0], x2.shape[3] - size[1]
    x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return torch.cat([x2, x1], dim=1)
