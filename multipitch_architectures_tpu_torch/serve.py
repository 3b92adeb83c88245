"""Serving artifacts: exported window forwards with the weights inside.

Counterpart of ``multipitch_architectures_tpu/serve.py``. The exported
unit is the protocol's batched window forward ``(B, 6, context,
n_bins_in) -> (B, n_bins_out)`` at a fixed batch size, traced by
``torch.export`` with the model's weights as constants of the program,
and written as one blob that a serving process loads and calls without
any model code or checkpoint. An int8 model (``eval.quantize_convs``)
exports too: each quantized conv is one node of the int8 GEMM's
registered operator (``ops/int8_gemm.py``), which the loader registers
by importing that module. Serving frames a recording's stride-1 windows
into these batches as ``eval.predict_framewise`` does; serving imports
no model code. For cross-batch
attention, export the ``cross_batch:<g>`` variant so that each dispatch
reproduces the reference's test batches (``ops/attention.py``).

The blob: the magic ``MPTPU\\x01``, a little-endian u32 header length,
a JSON header (``batch_mode``, ``batch_size``, ``context``,
``n_harmonics``, ``n_bins_in``, ``devices``, ``int8`` and the caller's
``meta``), then the ``torch.export.save`` payload. A blob without the
header loads as ``independent``.
"""

import io
import json
import struct
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_MAGIC = b"MPTPU\x01"
_INT8_OP = "mpt_torch.int8_conv2d_dequant"


class _WindowForward(nn.Module):
    """(B, 6, context, F) -> (B, bins): the model's first output,
    flattened per window (the PUnet's polyphony head is dropped, as the
    reference's test loop drops it, exp195f…py)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        y = self.model(x)
        if isinstance(y, tuple):
            y = y[0]
        return y.reshape(y.shape[0], -1)


def _check_batch_mode(batch_mode, batch_size):
    if not (batch_mode in ("independent", "cross_batch")
            or batch_mode.startswith("grouped:")):
        raise ValueError(f"unknown batch_mode {batch_mode!r}")
    if batch_mode.startswith("grouped:"):
        g = int(batch_mode.split(":", 1)[1])
        if g <= 0 or batch_size % g:
            raise ValueError(f"batch_size {batch_size} not a multiple of "
                             f"the grouped batch_mode's group {g}")


def export_window_forward(model, batch_size=50, context=75, n_harmonics=6,
                          n_bins_in=216, devices=None,
                          batch_mode="independent", meta=None) -> bytes:
    """Serialize the batched window forward of ``model`` as a
    self-contained artifact.

    Args:
        model: an ``nn.Module`` in eval mode, ``(B, 6, context, F) ->
            (B, 1, 1, bins)`` or a tuple whose first element is that;
            traced on its own device, its weights baked in. A
            ``quantize_convs`` copy exports the int8 serving mode with
            its activation scales as constants.
        devices: the device types the artifact may be loaded on (e.g.
            ``("cuda",)`` or ``("cuda", "cpu")``), recorded in the
            header. Default: the model's.
        batch_mode: the export's batch-composition contract, recorded in
            the header so that serving frames tails correctly
            (:func:`predict_framewise_exported`):

            - ``"independent"``: outputs do not depend on the batch's
              composition (no attention, or ``tokens`` attention);
            - ``"grouped:<g>"``: block-diagonal ``cross_batch:<g>``
              attention: each consecutive ``g`` windows are one
              reference test batch;
            - ``"cross_batch"``: plain cross-batch attention over the
              whole dispatch.
        meta: extra JSON-serializable header fields (model name,
            checkpoint provenance).

    Returns: the artifact's bytes (:func:`load_window_forward`).
    """
    _check_batch_mode(batch_mode, batch_size)
    if model.training:
        raise ValueError("export wants the model in eval mode")
    param = next(model.parameters())
    x = torch.zeros((batch_size, n_harmonics, context, n_bins_in),
                    device=param.device)
    with torch.no_grad():
        ep = torch.export.export(_WindowForward(model), (x,))
    int8 = any(n.op == "call_function" and _INT8_OP in str(n.target)
               for n in ep.graph.nodes)
    ep.example_inputs = None          # a batch of zeros: not worth keeping
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    header = dict(meta or {}, batch_mode=batch_mode, batch_size=batch_size,
                  context=context, n_harmonics=n_harmonics,
                  n_bins_in=n_bins_in, int8=int8,
                  devices=list(devices or (param.device.type,)))
    hdr = json.dumps(header).encode("utf-8")
    return _MAGIC + struct.pack("<I", len(hdr)) + hdr + buf.getvalue()


def load_window_forward(blob: bytes, device=None):
    """Load an artifact as a callable ``(B, 6, context, n_bins_in) ->
    (B, n_bins_out)`` float32 tensor on ``device`` (the card unless
    ``device="cpu"`` is given; see ``resolve_device``).

    Needs only torch and this package's operators: no model code or
    checkpoint. The program is moved to ``device``; a device type that
    the header does not list raises. The header is ``fn.meta`` (``{}``
    for a headerless blob), the ``ExportedProgram`` ``fn.program``."""
    from . import resolve_device

    device = resolve_device(device)
    meta = {}
    if blob[:len(_MAGIC)] == _MAGIC:
        n = struct.unpack("<I", blob[len(_MAGIC):len(_MAGIC) + 4])[0]
        off = len(_MAGIC) + 4
        meta = json.loads(blob[off:off + n].decode("utf-8"))
        blob = blob[off + n:]
    devices = meta.get("devices")
    if devices is not None and device.type not in devices:
        raise ValueError(f"the artifact lists devices {devices}; "
                         f"{device.type} is not one of them")
    # the int8 GEMM's operator must be registered before the load; a
    # headerless blob may hold it too
    from .ops import int8_gemm  # noqa: F401

    from torch.export.passes import move_to_device_pass

    ep = move_to_device_pass(torch.export.load(io.BytesIO(blob)), device)
    module = ep.module()

    def fn(x):
        with torch.no_grad():
            return module(torch.as_tensor(x, dtype=torch.float32,
                                          device=device))

    fn.meta, fn.device, fn.program = meta, device, ep
    return fn


def predict_framewise_exported(fn, inputs, batch_size=50, context=75,
                               compression=10.0, batch_mode=None,
                               strict=False):
    """Whole-recording framewise prediction through an artifact: the
    protocol's (half, half + 1) padding and stride-1 windowing
    (exp180d…py:427-443) in dispatches of the artifact's fixed size. The
    tail batch is padded with duplicates of the last window and cropped.

    Tail exactness depends on the export's batch-composition contract
    (``fn.meta['batch_mode']``, or ``batch_mode=``):

    - ``independent``: duplicate-padded tails are exact (the default for
      a headerless artifact, silently);
    - ``grouped:<g>``: every full ``g``-group of the tail is exact; only
      the final partial group (< g frames) sees duplicates in its
      attention: a warning names the frames, or ``strict=True`` raises;
    - ``cross_batch``: a padded tail changes ALL its real windows'
      outputs: a warning, or ``strict=True`` raises.

    Returns: (T, bins) float32 tensor on the artifact's device.
    """
    mode = batch_mode or getattr(fn, "meta", {}).get("batch_mode",
                                                     "independent")
    x = torch.as_tensor(inputs, dtype=torch.float32,
                        device=getattr(fn, "device", None))
    if compression is not None:
        x = torch.log1p(compression * x)
    half = context // 2
    xp = F.pad(x, (0, 0, half, half + 1))
    t = x.shape[1]
    offsets = torch.arange(-half, half + 1, device=x.device)

    tail = t % batch_size
    if tail:
        affected = 0
        if mode == "cross_batch":
            affected = tail
        elif mode.startswith("grouped:"):
            affected = tail % int(mode.split(":", 1)[1])
        if affected:
            msg = (f"{mode} artifact: the duplicate-padded tail batch "
                   f"changes the last {affected} frames' attention "
                   f"composition vs the reference protocol (batch "
                   f"{batch_size}, {tail}-frame tail); use a grouped "
                   f"export with a group dividing the tail, or "
                   f"eval.predict_framewise, for exact tails")
            if strict:
                raise ValueError(msg)
            warnings.warn(msg)

    outs = []
    for start in range(0, t, batch_size):
        centers = np.minimum(half + start + np.arange(batch_size),
                             half + t - 1)            # duplicate-pad tail
        idx = torch.as_tensor(centers, device=x.device)[:, None] + offsets
        y = fn(xp[:, idx].transpose(0, 1))          # (B, C, context, F)
        outs.append(y[:min(batch_size, t - start)])
    return torch.cat(outs)
