"""Whole-recording framewise inference.

Counterpart of ``multipitch_architectures_tpu/eval/inference.py``:

- :func:`predict_framewise`, the reference's windowed protocol: one
  stride-1 75-frame window per output frame through its test DataLoader
  (exp180d…py:417-443); the recording is padded by (half_context,
  half_context + 1) frames, and batch composition matters because of the
  cross-batch attention quirk. Every model of the zoo serves this way.
- :func:`predict_framewise_sharded`, the same protocol with the window
  batches split over a device mesh's ``data`` axis, protocol-exact for
  grouped cross-batch attention and for batch-independent models;
- :func:`predict_dense` and :func:`predict_dense_chunked`, for the
  segmentation CNNs only (stride 1 in time): one pass over the padded
  recording, or over overlapping chunks of it, gives every framewise
  prediction at about 1/75 of the windowed protocol's work. They are not
  the protocol: the dense pass sees the true neighbouring frames where
  each window's convs see zero padding (a worst measure delta of 2.6e-3
  on trained CNNs in the JAX package's measurements). The U-Nets pool
  in time and must serve windowed.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..data.windows import gather_windows
from ..parallel import apply_sharded, gather_rows, replicate, replicated


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


def _compressed(inputs, compression):
    x = torch.as_tensor(inputs, dtype=torch.float32)
    return torch.log1p(compression * x) if compression is not None else x


def _first(y):
    return y[0] if isinstance(y, tuple) else y


def _check_eval(model, name):
    if model.training:
        raise ValueError(f"{name} wants the model in eval mode")


@torch.no_grad()
def predict_framewise(model, inputs, context=75, batch_size=50,
                      compression=10.0, group=None, start_frame=0,
                      return_aux=False):
    """Per-frame predictions for a whole recording.

    Args:
        model: an ``nn.Module`` in eval mode mapping (B, 6, 75, 216) to
            (B, 1, 1, bins), or to a tuple whose first element is that
            (the PUnet's ``(salience, polyphony logits)``).
        inputs: raw HCQT (6, T, 216) tensor (uncompressed); the forward
            runs on its device.
        compression: log-compression γ (None if inputs are already
            compressed).
        group: attention group size ``g`` when the model was built with
            ``attn_mode='cross_batch:<g>'``. ``batch_size`` must then be
            a multiple of ``g``: each fused batch's groups reproduce the
            reference's ``g``-sized test batches, and the tail splits into
            full groups and a natural-size remainder.
        start_frame: predict frames ``[start_frame, T)`` only (the caller
            already holds the earlier ones, as ``predict_framewise_int8``
            does from its f32 calibration pass). Batch composition stays
            the reference's when it is a multiple of ``batch_size``.
        return_aux: also return the model's second output flattened per
            frame (the PUnet's polyphony logits, which the reference's
            notebook 02 reads) as ``(pred, aux)``; an empty
            ``(T - start_frame, 0)`` tensor for a model without one.

    Returns: (T - start_frame, bins) float32 tensor on ``inputs``'
    device, or ``(pred, aux)`` with ``return_aux``.
    """
    _check_eval(model, "predict_framewise")
    if group is not None and batch_size % group:
        raise ValueError(f"batch_size {batch_size} not a multiple of "
                         f"attention group {group}")
    x = _compressed(inputs, compression)
    t = x.shape[1]
    xp = _pad_inputs(x, context)
    half = context // 2
    outs, auxs = [], []
    start = int(start_frame)
    if not 0 <= start < t:
        raise ValueError(f"start_frame {start_frame} outside [0, {t})")
    while start < t:
        # the tail runs at its natural size: padding it with duplicate
        # windows would change the real windows' outputs under the
        # cross-batch attention quirk
        n = _next_batch_size(t - start, batch_size, group)
        y = model(gather_windows(xp, half + start + np.arange(n), context))
        aux = y[1] if isinstance(y, tuple) else None
        outs.append(_first(y).reshape(n, -1))
        if return_aux:
            auxs.append(aux.reshape(n, -1) if aux is not None
                        else outs[-1].new_zeros((n, 0)))
        start += n
    if return_aux:
        return torch.cat(outs), torch.cat(auxs)
    return torch.cat(outs)


@torch.no_grad()
def predict_framewise_sharded(model, inputs, mesh, context=75,
                              per_device_batch=50, compression=10.0,
                              group=None, batch_independent=False):
    """The windowed protocol with each fused batch of windows split over
    the ``data`` axis of ``mesh`` (``parallel.make_mesh``): the
    counterpart of the JAX package's ``predict_framewise_sharded``.

    The recording and the model are replicated on the mesh (one replica
    per data shard; the ``model`` axis is not used), and each dispatch
    gives every data shard ``per_device_batch`` consecutive windows.
    Protocol exactness needs each shard's batch to be made of the
    reference loader's batches, so the model must be batch-composition
    independent (no attention, or ``tokens`` attention: say so with
    ``batch_independent=True``) or use grouped ``cross_batch:<g>``
    attention with ``group=g`` and ``per_device_batch`` a multiple of
    ``g``, so that each group of ``g`` windows lies whole on one shard
    and reproduces one reference test batch. One of the two must be
    stated: a plain ``cross_batch`` model's outputs would change with the
    fused batch size, so calling with neither raises.

    The tail (fewer than ``per_device_batch`` times the data shards'
    windows) drains through the single-device path on the model's device
    with :func:`predict_framewise`'s batch composition.

    Returns: (T, bins) float32 tensor on ``inputs``' device, equal to
    :func:`predict_framewise`'s.
    """
    if group is None and not batch_independent:
        raise ValueError(
            "predict_framewise_sharded changes the dispatch batch size; "
            "pass group=<g> for a cross_batch:<g> model, or "
            "batch_independent=True for models whose outputs do not "
            "depend on batch composition (no attention / 'tokens' mode)")
    _check_eval(model, "predict_framewise_sharded")
    n_data = int(mesh.shape["data"])
    if group is not None and per_device_batch % group:
        raise ValueError(f"per_device_batch {per_device_batch} not a "
                         f"multiple of attention group {group}")
    x = _compressed(inputs, compression)
    t = x.shape[1]
    half = context // 2
    xp = _pad_inputs(x, context)
    placed = replicated(mesh).place(xp).shards[::mesh.shape["model"]]
    replicas = replicate(model, mesh, tensor_parallel=False)
    super_batch = per_device_batch * n_data
    outs = []
    start = 0
    while t - start >= super_batch:
        windows = [gather_windows(
            xp_d, half + start + d * per_device_batch
            + np.arange(per_device_batch), context)
            for d, xp_d in enumerate(placed)]
        y = gather_rows(apply_sharded(replicas, mesh, windows), mesh,
                        x.device)
        outs.append(_first(y).reshape(super_batch, -1))
        start += super_batch
    if start < t:
        device = next(model.parameters()).device
        outs.append(predict_framewise(
            model, x.to(device), context, per_device_batch, None, group,
            start_frame=start).to(x.device))
    return torch.cat(outs)


@torch.no_grad()
def predict_dense_chunked(model, inputs, context=75, chunk=512,
                          compression=10.0):
    """Dense inference over overlapping chunks, in one forward: chunk i
    spans frames ``[i·chunk, i·chunk + chunk + context)`` of the padded
    recording (padded further with zeros so that every span is in range)
    and gives ``chunk`` framewise predictions, so the work is
    ``(chunk + context) / chunk`` of one dense pass. The spans are
    gathered with one index tensor. For the segmentation CNNs only
    (module docstring).

    Returns: (T, bins) float32 tensor on ``inputs``' device.
    """
    _check_eval(model, "predict_dense_chunked")
    x = _compressed(inputs, compression)
    t = x.shape[1]
    xp = _pad_inputs(x, context)                        # (C, T + ctx, F)
    n_chunks = -(-t // chunk)
    need = n_chunks * chunk + context
    if xp.shape[1] < need:
        xp = F.pad(xp, (0, 0, 0, need - xp.shape[1]))
    idx = (torch.arange(n_chunks, device=xp.device)[:, None] * chunk
           + torch.arange(chunk + context, device=xp.device))
    segs = xp[:, idx].transpose(0, 1)                   # (N, C, span, F)
    y = _first(model(segs))                             # (N, 1, chunk+1, bins)
    y = y.reshape(n_chunks, y.shape[2], -1)[:, :chunk]
    return y.reshape(n_chunks * chunk, -1)[:t]


@torch.no_grad()
def predict_dense(model, inputs, context=75, compression=10.0):
    """One dense pass over the whole padded recording: every framewise
    prediction at once. For the segmentation CNNs only (module
    docstring).

    Returns: (T, bins) float32 tensor on ``inputs``' device.
    """
    _check_eval(model, "predict_dense")
    x = _compressed(inputs, compression)
    t = x.shape[1]
    y = _first(model(_pad_inputs(x, context)[None]))    # (1, 1, T+1, bins)
    return y.reshape(y.shape[2], -1)[:t]
