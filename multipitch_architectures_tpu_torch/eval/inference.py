"""Whole-recording framewise inference by the reference's windowed
protocol.

Counterpart of ``predict_framewise`` in
``multipitch_architectures_tpu/eval/inference.py``. The reference
predicts one stride-1 75-frame window per output frame through its test
DataLoader (exp180d…py:417-443): the recording is padded by
(half_context, half_context + 1) frames, and batch composition matters
because of the cross-batch attention quirk.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..data.windows import gather_windows


def _pad_inputs(inputs, context):
    """Pad (C, T, F) by (context//2, context//2 + 1) zero frames in time."""
    half = context // 2
    return F.pad(inputs, (0, 0, half, half + 1))


def _next_batch_size(remaining, batch_size, group):
    """Protocol-exact batch drain: full batches, then (with grouped
    attention) the tail's full groups, then the natural-size remainder,
    the reference loader's final short batch."""
    n = min(batch_size, remaining)
    if group is not None and batch_size > n > group:
        n = (n // group) * group
    return n


@torch.no_grad()
def predict_framewise(model, inputs, context=75, batch_size=50,
                      compression=10.0, group=None):
    """Per-frame predictions for a whole recording.

    Args:
        model: an ``nn.Module`` in eval mode mapping (B, 6, 75, 216) to
            (B, 1, 1, bins).
        inputs: raw HCQT (6, T, 216) tensor (uncompressed); the forward
            runs on its device.
        compression: log-compression γ (None if inputs are already
            compressed).
        group: attention group size ``g`` when the model was built with
            ``attn_mode='cross_batch:<g>'``. ``batch_size`` must then be
            a multiple of ``g``: each fused batch's groups reproduce the
            reference's ``g``-sized test batches, and the tail splits into
            full groups and a natural-size remainder.

    Returns: (T, bins) float32 tensor on ``inputs``' device.
    """
    if model.training:
        raise ValueError("predict_framewise wants the model in eval mode")
    if group is not None and batch_size % group:
        raise ValueError(f"batch_size {batch_size} not a multiple of "
                         f"attention group {group}")
    x = torch.as_tensor(inputs, dtype=torch.float32)
    if compression is not None:
        x = torch.log1p(compression * x)
    t = x.shape[1]
    xp = _pad_inputs(x, context)
    half = context // 2
    outs = []
    start = 0
    while start < t:
        # the tail runs at its natural size: padding it with duplicate
        # windows would change the real windows' outputs under the
        # cross-batch attention quirk
        n = _next_batch_size(t - start, batch_size, group)
        y = model(gather_windows(xp, half + start + np.arange(n), context))
        outs.append(y.reshape(n, -1))
        start += n
    return torch.cat(outs)
