"""The U-Nets' up-concat step (NCHW).

Counterpart of ``multipitch_architectures_tpu/ops/resize.py``; the
reference's ``unet_up_concat_padding`` upsamples with
``nn.Upsample(mode='bilinear', align_corners=True)``.
"""

import torch
import torch.nn.functional as F


def up_concat_pad(x1, x2, upsamp_fac=(2, 2)):
    """Upsample ``x1`` by ``upsamp_fac`` (bilinear, align_corners=True),
    zero-pad it to ``x2``'s spatial size and concat ``[x2, x1]`` along
    channels. The pad order is the reference's: left = dW//2,
    right = dW - dW//2, top = dH//2, bottom = dH - dH//2."""
    size = (x1.shape[2] * upsamp_fac[0], x1.shape[3] * upsamp_fac[1])
    x1 = F.interpolate(x1, size=size, mode="bilinear", align_corners=True)
    dh, dw = x2.shape[2] - size[0], x2.shape[3] - size[1]
    x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return torch.cat([x2, x1], dim=1)
