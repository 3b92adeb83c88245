"""Context windows around center frames.

Counterpart of ``multipitch_architectures_tpu/data/windows.py``, with the
reference's semantics (hcqt_datasets.py:63-75): a window of ``context``
frames is centered at ``index·stride + context//2``.
"""

import numpy as np
import torch


def num_windows(n_frames: int, context: int, stride: int) -> int:
    """len(dataset_context) (hcqt_datasets.py:63-65)."""
    return (n_frames - context) // stride


def num_segments(n_frames: int, context: int, seglength: int,
                 stride: int) -> int:
    """len(dataset_context_segm) (hcqt_datasets.py:194-196)."""
    return (n_frames - context - seglength + stride) // stride


def window_centers(n_frames: int, context: int, stride: int,
                   offset: int = 0) -> np.ndarray:
    """Center-frame indices of every window of one file, shifted by
    ``offset`` (the file's start frame in a concatenated tensor)."""
    n = num_windows(n_frames, context, stride)
    return offset + context // 2 + stride * np.arange(n, dtype=np.int64)


def gather_windows(inputs, centers, context: int):
    """Windows of ``context`` frames around ``centers``.

    inputs: (C, T, F) tensor; centers: (B,) integer array or tensor.
    Returns (B, C, context, F) on ``inputs``' device.

    Every window must lie inside ``inputs``: the JAX package's
    ``dynamic_slice`` clamps a start that is out of range, where indexing
    here would wrap or fail, so such centers raise instead. Callers pad
    the recording first (``eval.inference._pad_inputs``).
    """
    half = context // 2
    centers = torch.as_tensor(centers, dtype=torch.long)
    lo, hi = int(centers.min()) - half, int(centers.max()) - half + context
    if lo < 0 or hi > inputs.shape[1]:
        raise ValueError(f"windows span frames [{lo}, {hi}) of an input "
                         f"with {inputs.shape[1]} frames")
    return _gather(inputs, centers.to(inputs.device), context)


def _gather(inputs, centers, context: int):
    """``gather_windows`` without the bounds check, which reads the
    centers on the host: for centers on ``inputs``' device that are valid
    by construction (``data.pipeline``)."""
    idx = (centers[:, None] - context // 2
           + torch.arange(context, device=inputs.device))   # (B, context)
    return inputs[:, idx].transpose(0, 1)                   # (B, C, ctx, F)


def gather_targets(targets, centers):
    """targets: (T, n_bins) tensor; centers: (B,) -> (B, 1, 1, n_bins)."""
    centers = torch.as_tensor(centers, dtype=torch.long, device=targets.device)
    return targets[centers][:, None, None, :]
