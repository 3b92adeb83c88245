"""W8A8 serving of any plain reference model, in plain PyTorch: the
arithmetic that a configuration's ``"precision": "int8"`` states, written
from its ``quant`` block.

Every plain convolution (undilated, ungrouped, zero padding given as
numbers) whose kernel holds at least ``min_kernel_elems`` weights runs
as

- weights: per output channel, scale max |w| over (Cin, kh, kw), at
  least 1e-12, over 127; quantized as round(w / scale), half to even,
  clamped to ±127;
- activations: one static scale per convolution and recording, max |x|
  of its input over the calibration windows over 127, computed in
  float64 and used in float32; quantized as the weights;
- the sums of the integer products exact, as a float64 convolution of
  the integer tensors (cuDNN off, so that no FFT or Winograd algorithm
  rounds them);
- the dequantize ``(sums · weight scale) · activation scale + bias`` in
  float32, each step rounded to nearest.

Everything else (norms, attention, pooling, the small convolutions)
stays float32. A recording is served as the test protocol serves it:
the first ``cal_batches`` fused batches of windows in float32, which
also calibrate the scales and serve their frames, then the rest W8A8, in
the attention's groups of consecutive windows.

``qmax`` 7 in place of 127 gives the 4-bit control. Nothing here imports
the program under test. :func:`follow` reads the program's tensors to
judge them: it follows the program convolution by convolution.
"""

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn

QMAX = 127
QMAX_CONTROL = 7        # int4: the precision below int8


def eligible(model, min_kernel_elems):
    """``[(name, conv)]`` of the convolutions that run W8A8, in module
    order."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, nn.Conv2d) and m.dilation == (1, 1)
            and m.groups == 1 and m.padding_mode == "zeros"
            and not isinstance(m.padding, str)
            and m.weight.numel() >= min_kernel_elems]


def _scalar(value, like):
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize(t, scale, qmax):
    """round(t / scale), half to even, clamped to ±qmax (float)."""
    return torch.clamp(torch.round(t / scale), -qmax, qmax)


def weight_scales(w, qmax=QMAX):
    """Per output channel of an OIHW kernel."""
    return torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / _scalar(
        qmax, w)


def conv(module, x, scale, qmax=QMAX):
    """``module`` (an ``nn.Conv2d``) on ``x`` as W8A8 at the activation
    ``scale`` (a 0-dim float32 tensor)."""
    w = module.weight
    ws = weight_scales(w, qmax)
    wq = quantize(w, ws[:, None, None, None], qmax)
    xq = quantize(x, scale, qmax)
    with torch.backends.cudnn.flags(enabled=False):
        sums = F.conv2d(xq.double(), wq.double(), stride=module.stride,
                        padding=module.padding)
    y = sums.float() * ws[:, None, None]
    y = y * scale
    if module.bias is not None:
        y = y + module.bias[:, None, None]
    return y


@contextlib.contextmanager
def quantized(model, scales, min_kernel_elems, qmax=QMAX):
    """``model`` with each eligible convolution W8A8 at its static scale
    (``scales[name]``) inside the block."""
    convs = eligible(model, min_kernel_elems)
    for name, m in convs:
        m.forward = functools.partial(conv, m, scale=scales[name],
                                      qmax=qmax)
    try:
        yield model
    finally:
        for _, m in convs:
            del m.forward


def _rel(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@torch.no_grad()
def follow(model, windows, program, scales, group, min_kernel_elems, exact,
           qmax=QMAX):
    """``model`` over one batch of the program's ``windows``, fed at each
    eligible convolution the program's own input and output
    (``program[name]``, the batch's (input, output)) in place of its own:
    teacher forcing, so that the bin flips of one W8A8 convolution do not
    reach the next. Returns (the batch's (B, bins) outputs, gaps):

    - ``stage_rel``: the largest gap between a convolution's own input
      and the program's, over max |program's|: the float32 layers between
      the program's W8A8 convolutions;
    - ``sum_gap`` (with ``exact``): the largest gap between the program's
      output and this module's W8A8 convolution of the program's input at
      ``scales[name]``, in units of its output's last integer step (weight
      scale times activation scale): 0 where the integer sums and the
      dequantize agree.

    A convolution that the program did not run W8A8 reads infinite."""
    convs = eligible(model, min_kernel_elems)
    gaps = {"stage_rel": 0.0, "sum_gap": 0.0}
    rows = [slice(0, 0)]

    def fed(m, name, x):
        if name not in program:
            gaps["stage_rel"] = gaps["sum_gap"] = float("inf")
            return conv(m, x, scales.get(name, x.new_ones(())), qmax)
        xp, yp = (t[rows[0]] for t in program[name])
        gaps["stage_rel"] = max(gaps["stage_rel"], _rel(x, xp))
        if exact:
            y = conv(m, xp, scales[name], qmax)
            step = weight_scales(m.weight, qmax)[:, None, None] * scales[name]
            gaps["sum_gap"] = max(gaps["sum_gap"],
                                  float(((yp - y).abs() / step).max()))
        return yp

    for name, m in convs:
        m.forward = functools.partial(fed, m, name)
    outs = []
    try:
        for s in range(0, windows.shape[0], group):
            rows[0] = slice(s, s + group)
            outs.append(model(windows[rows[0]]).reshape(
                windows[rows[0]].shape[0], -1))
    finally:
        for _, m in convs:
            del m.forward
    return torch.cat(outs), gaps


@torch.no_grad()
def forward(model, xp, frames, context, group):
    """(len(frames), bins) outputs of ``model`` for the windows of the
    given ``frames`` of the padded input ``xp`` (C, T + context, F), in
    the attention's groups of ``group`` consecutive entries."""
    offsets = torch.arange(context, device=xp.device)
    outs = []
    for s in range(0, len(frames), group):
        idx = frames[s:s + group][:, None] + offsets
        outs.append(model(xp[:, idx].transpose(0, 1)).reshape(
            idx.shape[0], -1))
    if not outs:
        return xp.new_zeros((0, 0))
    return torch.cat(outs)


def calibrate(model, xp, frames, context, group, min_kernel_elems, qmax):
    """The float32 pass over the calibration windows: (its outputs,
    {name: scale}), each scale max |input| of its convolution over the
    windows, in float64, over ``qmax``, as a float32 tensor."""
    maxes = {}

    def hook(name):
        def record(_, args):
            v = float(args[0].abs().max())
            maxes[name] = max(maxes.get(name, 0.0), v)
        return record

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in eligible(model, min_kernel_elems)]
    try:
        out = forward(model, xp, frames, context, group)
    finally:
        for h in handles:
            h.remove()
    return out, scales_of(maxes, qmax, xp.device)


def scales_of(maxes, qmax, device):
    """{name: max(max |input|, 1e-12) / qmax in float64, as a float32
    tensor} of {name: max |input|}."""
    return {k: torch.tensor(max(v, 1e-12) / qmax, dtype=torch.float32,
                            device=device) for k, v in maxes.items()}


def transcribe(model, hcqt, compression, context, batch, group, quant,
               qmax=QMAX):
    """(calibration outputs, W8A8 outputs) of one recording's raw HCQT
    (harmonics, T, bins) served as the ``quant`` block states: the first
    ``cal_batches`` batches of ``batch`` windows calibrate (a recording
    shorter than that repeats its last frame, for the scales only) and,
    where whole, are served from the float32 pass; the later frames run
    W8A8."""
    if quant["per_channel"] or quant["gate"] is not None:
        raise ValueError("the reference serves per-tensor scales, ungated")
    if batch % group:
        raise ValueError(f"batch {batch} not a multiple of group {group}")
    x = torch.log1p(compression * hcqt)
    t, half = x.shape[1], context // 2
    xp = F.pad(x, (0, 0, half, half + 1))
    n_cal = min(quant["cal_batches"], -(-t // batch))
    n_full = min(quant["cal_batches"], t // batch)
    frames = torch.arange(n_cal * batch, device=x.device).clamp_(max=t - 1)
    cal, scales = calibrate(model, xp, frames, context, group,
                            quant["min_kernel_elems"], qmax)
    start = n_full * batch
    rest = torch.arange(start, t, device=x.device)
    with quantized(model, scales, quant["min_kernel_elems"], qmax):
        q = forward(model, xp, rest, context, group)
    if not len(rest):
        q = cal.new_zeros((0, cal.shape[1]))
    return cal[:start], q
