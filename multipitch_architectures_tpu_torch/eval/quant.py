"""int8 (W8A8) quantized inference for the conv stacks.

Counterpart of ``multipitch_architectures_tpu/eval/quant.py``. Every
plain ``nn.Conv2d`` whose kernel holds at least ``min_kernel_elems``
weights runs as

    per-output-channel symmetric int8 weights,
    per-tensor (or per-input-channel) int8 activations: dynamic (max-abs
        per call) or calibrated static scales,
    int32 sums on the card's int8 GEMM, dequantize and bias in float32
        fused into its epilogue (``ops.int8_gemm.int8_conv2d_dequant``).

Norms, attention, pooling, resizing and the small head convs stay
float32. Where the JAX package swaps convs at trace time with a flax
method interceptor, :func:`quantize_convs` returns a copy of the module
tree (sharing every parameter) in which each eligible conv is an
:class:`Int8Conv2d`. Policies are keyed by torch module names
(``inc.double_conv.0``); ``models.torch_module_name`` maps the JAX
package's module paths (``inc/conv1``) to them. Scales are values
(float32 tensors in a dict the copy reads at call time), not structure,
so a new recording's calibration changes no module: the eager
counterpart of the JAX package's compile-once ``quantized_serving_fn``.

An opt-in serving mode, not protocol-exact: its accuracy cost is
measured per checkpoint by :func:`int8_drift_report` and bounded by
:func:`auto_hybrid_int8` (``predict_framewise_int8(gate=...)``).

The arithmetic follows the JAX package's step for step, because a
last-ulp difference upstream of ``round(x / s)`` flips a quantization
bin: round half to even (``torch.round``, like ``jnp.round``); quantize
by division, with the divisor a tensor on the data's device (PyTorch's
CUDA kernels divide by a Python or CPU scalar as a multiplication by
its reciprocal); per-tensor scales computed in float64 and used in
float32; dynamic dequantize ``y·(ws·xs)``, static ``(y·ws)·xs``, then
the bias. Outputs of two different programs are still comparable only to
bin-flip noise (the JAX package's tests use 5e-3).
"""

import copy
import warnings

import numpy as np
import torch
from torch import nn

from ..data.windows import gather_windows
from ..ops.int8_gemm import int8_conv2d_dequant
from .inference import (_first, _next_batch_size, _pad_inputs,
                        predict_framewise)
from .measures import calculate_eval_measures
from .mireval import calculate_mpe_measures_mireval

QMAX = 127.0


def _constant(value, like):
    """``value`` as a 0-dim float32 tensor on ``like``'s device, made by a
    fill (no host-to-device copy, so no synchronisation)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _quantize(t, scale):
    """clip(round(t / scale), -127, 127) as int8."""
    q = t / scale
    return q.round_().clamp_(-QMAX, QMAX).to(torch.int8)


def _weight_scales(w):
    """Per-output-channel scales of an OIHW kernel: max |w| over
    (Cin, kh, kw), at least 1e-12, over 127."""
    return torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / _constant(
        QMAX, w)


def _conv_dequant(xq, wq, stride, padding, s1, s2, bias):
    """int8 NCHW activation, int8 OIHW kernel -> ((int32 sums · s1) · s2)
    + bias in float32, as an NCHW view of the channels-last result."""
    y = int8_conv2d_dequant(xq.permute(0, 2, 3, 1).contiguous(),
                            wq.permute(0, 2, 3, 1).contiguous(), stride,
                            padding, s1, s2, bias)
    return y.permute(0, 3, 1, 2)


def quantized_conv(x, weight, bias, stride, padding):
    """W8A8 conv with a dynamic activation scale (max |x| of this call).

    x: (B, Cin, H, W) float32; weight: (Cout, Cin, kh, kw) float32.
    Returns (B, Cout, Ho, Wo) float32 (a channels-last view)."""
    ws = _weight_scales(weight)
    wq = _quantize(weight, ws[:, None, None, None])
    xs = torch.clamp_min(x.abs().amax(), 1e-12) / _constant(QMAX, x)
    return _conv_dequant(_quantize(x, xs), wq, stride, padding, ws * xs,
                         _constant(1.0, x), bias)


def quantized_conv_static(x, weight, bias, stride, padding, x_scale):
    """W8A8 conv with a calibrated activation scale: a scalar
    (per-tensor) or a (Cin,) vector (per-input-channel). A channel scale
    folds into the kernel's Cin axis before the weights are quantized
    (sum_c (x/s_c)·(w·s_c) = sum_c x·w), so the conv and its (Cout,)
    dequantize are those of the per-tensor case."""
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    if xs.dim() == 1:
        weight = weight * xs[None, :, None, None]
    ws = _weight_scales(weight)
    wq = _quantize(weight, ws[:, None, None, None])
    xq = _quantize(x, xs if xs.dim() == 0 else xs[None, :, None, None])
    return _conv_dequant(xq, wq, stride, padding, ws,
                         xs if xs.dim() == 0 else _constant(1.0, x), bias)


class Int8Conv2d(nn.Module):
    """An ``nn.Conv2d`` served as a W8A8 conv. It shares the conv's
    weight and bias, and reads its activation scale from
    ``activation_scales[name]`` at call time: static when the key is
    there, dynamic when it is not."""

    def __init__(self, conv: nn.Conv2d, name: str, activation_scales=None):
        super().__init__()
        self.weight, self.bias = conv.weight, conv.bias
        self.stride, self.padding = conv.stride, conv.padding
        self.name = name
        self.activation_scales = activation_scales

    def forward(self, x):
        scales = self.activation_scales
        scale = None if scales is None else scales.get(self.name)
        if scale is None:
            return quantized_conv(x, self.weight, self.bias, self.stride,
                                  self.padding)
        return quantized_conv_static(x, self.weight, self.bias, self.stride,
                                     self.padding, scale)


def _plain_conv(m) -> bool:
    """Only undilated, ungrouped, zero-padded 2-D convs are quantized."""
    return (isinstance(m, nn.Conv2d) and m.dilation == (1, 1)
            and m.groups == 1 and m.padding_mode == "zeros"
            and not isinstance(m.padding, str))


def eligible_convs(model, min_kernel_elems: int = 4096):
    """``[(name, conv)]`` of the convs that the int8 mode quantizes, in
    module order."""
    return [(name, m) for name, m in model.named_modules()
            if _plain_conv(m) and m.weight.numel() >= min_kernel_elems]


def _replaced(module, replacements, prefix=""):
    """Shallow copy of ``module`` whose submodules named in
    ``replacements`` ({module name: new module}) are replaced, copying
    the modules on the way to them. Every other module, parameter and
    buffer is shared."""
    new = copy.copy(module)
    new._modules = type(module._modules)()
    for name, child in module._modules.items():
        full = prefix + name
        if full in replacements:
            child = replacements[full]
        elif any(t.startswith(full + ".") for t in replacements):
            child = _replaced(child, replacements, full + ".")
        new._modules[name] = child
    return new


def quantize_convs(model, min_kernel_elems: int = 4096,
                   activation_scales=None, exclude=()):
    """The int8 serving variant of ``model``: a copy of its module tree,
    sharing every parameter, in which every eligible conv (at least
    ``min_kernel_elems`` weights, see :func:`eligible_convs`) not named
    in ``exclude`` is an :class:`Int8Conv2d`. ``activation_scales`` is a
    {module name: scale} dict (:func:`calibrate_activation_scales`),
    read at call time: a conv with a key runs static, one without runs
    dynamic. Excluded convs are the model's own float32 convs."""
    exclude = frozenset(exclude)
    return _replaced(model, {
        name: Int8Conv2d(conv, name, activation_scales)
        for name, conv in eligible_convs(model, min_kernel_elems)
        if name not in exclude})


def percentile_abs(a, percentile, per_channel=False):
    """``jnp.percentile(|a|, percentile)`` of an NCHW tensor, over all
    its elements or, with ``per_channel``, per channel (dim 1): linear
    interpolation between the two order statistics around
    ``percentile / 100 · (n - 1)``, the position and weights in float32
    as the JAX package's calibration computes them inside its compiled
    probe (an eager ``jnp.percentile`` call may fold the two constants
    otherwise and move the position by its last bit). The two order
    statistics come from one ``torch.topk`` over the shorter side of the
    position (0.1 % of the values for 99.9): ``torch.quantile`` refuses
    more than 2^24 elements, fewer than one full-width ``inc`` input of
    a batch of 250 holds, and ``torch.kthvalue`` of one such row runs in
    a single block on the card."""
    a = a.abs()
    a = (a.transpose(0, 1).reshape(a.shape[1], -1) if per_channel
         else a.reshape(-1))
    n = a.shape[-1]
    f32 = np.float32
    last = f32(n) - f32(1)
    pos = f32(percentile) / f32(100) * last
    hi_w = pos - np.floor(pos)
    lo_w = f32(1) - hi_w
    lo = int(np.clip(np.floor(pos), 0, last))
    hi = int(np.clip(np.ceil(pos), 0, last))
    if lo >= n // 2:                       # ranks lo.. n-1, descending
        top = a.topk(n - lo, dim=-1).values
        lo_v, hi_v = top[..., -1], top[..., -1 - (hi - lo)]
    else:                                  # ranks 0 .. hi, ascending
        bottom = a.topk(hi + 1, dim=-1, largest=False).values
        lo_v, hi_v = bottom[..., lo], bottom[..., hi]
    return lo_v * float(lo_w) + hi_v * float(hi_w)


def _capture(model, sample_inputs, min_kernel_elems, per_channel,
             percentile=None):
    """float32 forwards over ``sample_inputs`` with a pre-hook on every
    eligible conv. Returns ({name: max over the batches of max |input|,
    or of its ``percentile``, on the device}, [the forwards' (B, bins)
    outputs], [their (B, n_aux) second outputs, (B, 0) for a model with
    one output])."""
    if model.training:
        raise ValueError("calibration wants the model in eval mode")
    maxes, preds, auxs = {}, [], []

    def hook_for(name):
        def hook(_, args):
            if percentile is not None:
                v = percentile_abs(args[0], percentile, per_channel)
            else:
                a = args[0].abs()
                v = a.amax(dim=(0, 2, 3)) if per_channel else a.amax()
            maxes[name] = (torch.maximum(maxes[name], v) if name in maxes
                           else v)
        return hook

    handles = [m.register_forward_pre_hook(hook_for(name))
               for name, m in eligible_convs(model, min_kernel_elems)]
    try:
        with torch.no_grad():
            for x in sample_inputs:
                y = model(x)
                aux = y[1] if isinstance(y, tuple) else None
                preds.append(_first(y).reshape(x.shape[0], -1))
                auxs.append(aux.reshape(x.shape[0], -1) if aux is not None
                            else preds[-1].new_zeros((x.shape[0], 0)))
    finally:
        for h in handles:
            h.remove()
    return maxes, preds, auxs


def _scales_from_maxes(maxes, margin, per_channel):
    """Scales from the captured maxima, fetched from the device once:
    per-channel in float32, per-tensor in float64 (as the JAX package
    computes them in numpy and Python floats), each returned as a
    float32 tensor on the maxima's device."""
    if not maxes:
        return {}
    names = list(maxes)
    device = maxes[names[0]].device
    flat = torch.cat([maxes[k].reshape(-1) for k in names]).cpu().numpy()
    scales, i = {}, 0
    for k in names:
        v = flat[i:i + maxes[k].numel()]
        i += v.size
        if per_channel:
            s = np.maximum(v * margin, 1e-12).astype(np.float32) / 127.0
        else:
            s = max(float(v[0]) * margin, 1e-12) / 127.0
        scales[k] = torch.as_tensor(s, dtype=torch.float32, device=device)
    return scales


def calibrate_activation_scales(model, sample_inputs,
                                min_kernel_elems: int = 4096,
                                percentile: float = None,
                                margin: float = 1.0,
                                per_channel: bool = False):
    """Per-conv static activation scales from representative window
    batches: {module name: max |input| · margin / 127}, a scalar, or a
    (Cin,) vector with ``per_channel``, as float32 tensors on the model's
    device. ``percentile`` (e.g. 99.9): each batch gives that percentile
    of |input| instead of its max (:func:`percentile_abs`), and the
    batches' largest is taken. ``margin`` > 1 leaves headroom for inputs
    beyond the calibration range."""
    maxes, _, _ = _capture(model, sample_inputs, min_kernel_elems,
                           per_channel, percentile)
    return _scales_from_maxes(maxes, margin, per_channel)


def calibrate_with_predictions(model, sample_inputs,
                               min_kernel_elems: int = 4096,
                               margin: float = 1.0,
                               per_channel: bool = False,
                               percentile: float = None):
    """Per-recording calibration that keeps the float32 predictions: the
    calibration pass is a full-precision protocol forward, so its outputs
    serve the calibration windows (:func:`predict_framewise_int8`).
    Returns ``(scales, preds)``, ``preds`` a (B, bins) tensor per sample
    batch; ``percentile`` as :func:`calibrate_activation_scales`."""
    maxes, preds, _ = _capture(model, sample_inputs, min_kernel_elems,
                               per_channel, percentile)
    return _scales_from_maxes(maxes, margin, per_channel), preds


DRIFT_GATE_MEASURES = (
    "precision", "recall", "f_measure", "cosine_sim",
    "binary_crossentropy", "euclidean_distance", "binary_accuracy",
    "soft_accuracy", "accum_energy", "roc_auc_measure",
    "average_precision_score")


@torch.no_grad()
def _predictions(model, windows):
    """(sum of B, bins) float32 numpy predictions over window batches."""
    return torch.cat([_first(model(x)).reshape(x.shape[0], -1)
                      for x in windows]).cpu().numpy()


def measure_drift(pred_f, pred_q, threshold: float = 0.4,
                  min_pitch: int = 24):
    """The drift gate's measures: with ``pred_f > threshold`` as
    pseudo-targets, ``{measure: |m(pseudo, pred_q) - m(pseudo, pred_f)|}``
    for the 11 + 14 measures, over (T, bins) numpy predictions. Returns
    ``(drift, skipped)``, ``skipped`` the measures undefined under the
    pseudo-targets."""
    pseudo = (pred_f > threshold).astype(np.float32)
    drift, skipped = {}, []
    for m in DRIFT_GATE_MEASURES:
        with warnings.catch_warnings():     # ROC-AUC of one class: NaN
            warnings.simplefilter("ignore", RuntimeWarning)
            a = calculate_eval_measures(pseudo, pred_f, [m], threshold)[m]
            b = calculate_eval_measures(pseudo, pred_q, [m], threshold)[m]
        if np.isfinite(a) and np.isfinite(b):
            drift[m] = abs(a - b)
        else:
            skipped.append(m)
    mf = calculate_mpe_measures_mireval(pseudo, pred_f, threshold=threshold,
                                        min_pitch=min_pitch)
    mq = calculate_mpe_measures_mireval(pseudo, pred_q, threshold=threshold,
                                        min_pitch=min_pitch)
    for k in mf:
        drift[k] = abs(mf[k] - mq[k])
    return drift, skipped


def int8_drift_report(model, cal_windows, activation_scales=None,
                      min_kernel_elems: int = 4096, threshold: float = 0.4,
                      min_pitch: int = 24, gate: float = 1e-3, exclude=(),
                      f32_predictions=None):
    """Accuracy gate of the int8 serving mode. The float32 forward's own
    thresholded predictions are pseudo-targets: for each of the 11 + 14
    measures the drift is ``|m(pseudo, int8) - m(pseudo, f32)|`` over
    ``cal_windows`` (:func:`measure_drift`). ``f32_predictions`` (from an
    earlier report on the same windows) skips the float32 forward.

    Returns a dict with ``worst``, ``measures``, ``skipped`` (measures
    undefined under the pseudo-targets), ``pred_max`` / ``pred_mean``,
    ``gate`` and ``passed`` (worst <= gate).
    """
    pred_f = (_predictions(model, cal_windows) if f32_predictions is None
              else f32_predictions)
    pred_q = _predictions(
        quantize_convs(model, min_kernel_elems, activation_scales, exclude),
        cal_windows)
    drift, skipped = measure_drift(pred_f, pred_q, threshold, min_pitch)
    worst = max(drift.values()) if drift else float("inf")
    return dict(worst=worst, measures=drift, skipped=skipped,
                pred_max=float(np.abs(pred_f - pred_q).max()),
                pred_mean=float(np.abs(pred_f - pred_q).mean()),
                gate=gate, passed=bool(drift) and worst <= gate)


def auto_hybrid_int8(model, cal_windows, min_kernel_elems: int = 4096,
                     gate: float = 1e-3, per_channel: bool = False,
                     threshold: float = 0.4, min_pitch: int = 24,
                     verbose: bool = False, verify_windows=None,
                     activation_scales=None, proxy_margin: float = 2.0):
    """An int8 policy that passes the drift gate on this checkpoint.

    1. full static int8: return it if the gate passes;
    2. rank every eligible conv by its standalone damage (quantize only
       that conv, max |pred - f32| over the verification windows);
    3. demote convs to exact float32 (``exclude``) in damage order,
       re-measuring the gate after each, until it passes. Demoting every
       conv gives the float32 forward (drift 0), so the search ends with
       a passing report.

    Scales come from ``cal_windows`` (or ``activation_scales``, copied);
    the gate is verified on ``verify_windows`` (default: the calibration
    windows; :func:`predict_framewise_int8` passes the whole recording).
    The search gates the pseudo-target proxy at ``gate / proxy_margin``:
    the proxy under-read the true drift by about 1.8x on the trained
    exp180e in the JAX package's measurements.

    Returns ``(policy, report)``: ``policy`` holds ``activation_scales``,
    ``exclude`` (in demotion order) and ``min_kernel_elems``, splattable
    into :func:`quantize_convs`; ``report`` is the last
    :func:`int8_drift_report`.
    """
    scales = (dict(activation_scales) if activation_scales is not None
              else calibrate_activation_scales(model, cal_windows,
                                               min_kernel_elems,
                                               per_channel=per_channel))
    verify = cal_windows if verify_windows is None else verify_windows
    search_gate = gate / proxy_margin
    pred_f = _predictions(model, verify)

    def report_for(exclude):
        return int8_drift_report(model, verify, scales, min_kernel_elems,
                                 threshold, min_pitch, search_gate, exclude,
                                 f32_predictions=pred_f)

    report = report_for(())
    demoted = []
    if not report["passed"] and scales:
        # every eligible conv, not only the keys of `scales`: one without
        # a scale runs dynamic int8 and drifts too
        paths = [name for name, _ in eligible_convs(model, min_kernel_elems)]
        paths += [k for k in scales if k not in paths]
        damage = {}
        for k in paths:
            only_k = quantize_convs(model, min_kernel_elems,
                                    {k: scales[k]} if k in scales else {},
                                    set(paths) - {k})
            damage[k] = float(np.abs(_predictions(only_k, verify)
                                     - pred_f).max())
        ranked = sorted(damage, key=damage.get, reverse=True)
        if verbose:
            for k in ranked:
                print(f"  standalone damage {k:40s} {damage[k]:.5f}")
        for k in ranked:
            demoted.append(k)
            scales.pop(k, None)
            report = report_for(tuple(demoted))
            if verbose:
                print(f"  demoted {k} -> worst {report['worst']:.5f} "
                      f"{'PASS' if report['passed'] else 'fail'}")
            if report["passed"]:
                break
    policy = dict(activation_scales=scales, exclude=tuple(demoted),
                  min_kernel_elems=min_kernel_elems)
    return policy, report


def _gate_verify_windows(xp, t, batch_size, context, group=None):
    """The drift gate's verification set: the protocol's own batching of
    the whole recording, every frame once, in the drain of
    :func:`predict_framewise`: full batches, then (with grouped
    attention) the tail's full groups, then the natural-size remainder.
    The JAX package's set batches by ``batch_size`` only, so there a
    ragged tail longer than the group makes grouped attention raise (a
    10-s request, 431 frames, at batch 250 and group 50); without a group
    the two sets are the same."""
    half = context // 2
    out, start = [], 0
    while start < t:
        n = _next_batch_size(t - start, batch_size, group)
        out.append(gather_windows(xp, half + start + np.arange(n), context))
        start += n
    return out


def predict_framewise_int8(model, inputs, context: int = 75,
                           batch_size: int = 50, compression=10.0,
                           group=None, cal_batches: int = 4,
                           per_channel: bool = False,
                           min_kernel_elems: int = 4096, gate: float = None,
                           reuse_cal_predictions: bool = True,
                           **predict_kwargs):
    """Whole-recording framewise prediction in the int8 serving mode.

    Per-recording calibration: activation scales come from the first
    ``cal_batches`` protocol batches of this recording (fused into one
    forward when ``group`` is set; a recording shorter than that adds
    batches whose centres are clipped to the last frame, used for scales
    only). Then the windowed protocol runs with W8A8 convs. Arguments
    as :func:`~multipitch_architectures_tpu_torch.eval.predict_framewise`;
    ``predict_kwargs`` go to it (``return_aux=True`` returns ``(pred,
    aux)``, the aux rows of the calibration span from the float32
    calibration pass, the rest from the int8 pass).

    Args:
        gate: if set (e.g. 1e-3), verify the policy on the whole
            recording and demote drift-dominating convs to float32 until
            the measure drift passes (:func:`auto_hybrid_int8`).
        reuse_cal_predictions: serve the calibration span from the
            calibration pass's exact float32 outputs (default). Only
            full calibration batches are reused: their composition is
            the reference loader's, so the output is float32 on the
            calibration span and int8 after it.

    Returns: (T, bins) float32 tensor on ``inputs``' device.
    """
    x = torch.as_tensor(inputs, dtype=torch.float32)
    if compression is not None:
        x = torch.log1p(compression * x)
    half = context // 2
    xp = _pad_inputs(x, context)
    t = x.shape[1]

    n_cal = min(cal_batches, -(-t // batch_size))
    n_full = min(cal_batches, t // batch_size)
    cal = []
    if group is not None and n_full:
        cal.append(gather_windows(xp, half + np.arange(n_full * batch_size),
                                  context))
    else:
        cal += [gather_windows(xp, half + batch_size * b
                               + np.arange(batch_size), context)
                for b in range(n_full)]
    for b in range(n_full, n_cal):
        centers = np.minimum(half + batch_size * b + np.arange(batch_size),
                             half + t - 1)
        cal.append(gather_windows(xp, centers, context))

    maxes, cal_preds, cal_auxs = _capture(model, cal, min_kernel_elems,
                                          per_channel)
    scales = _scales_from_maxes(maxes, 1.0, per_channel)

    exclude = ()
    if gate is not None:
        verify = _gate_verify_windows(xp, t, batch_size, context, group)
        policy, report = auto_hybrid_int8(model, cal, min_kernel_elems, gate,
                                          per_channel=per_channel,
                                          verify_windows=verify,
                                          activation_scales=scales)
        scales, exclude = policy["activation_scales"], policy["exclude"]
        if not report["passed"]:
            warnings.warn(f"int8 gate not met after the hybrid search "
                          f"(worst drift {report['worst']:.2e} > gate "
                          f"{gate:.0e}); serving the best policy found",
                          RuntimeWarning)

    return_aux = bool(predict_kwargs.get("return_aux"))
    start_frame = n_full * batch_size if reuse_cal_predictions else 0
    # reused rows come from the full batches only: the rows beyond them
    # belong to clipped batches
    head = (torch.cat(cal_preds)[:min(start_frame, t)],
            torch.cat(cal_auxs)[:min(start_frame, t)])
    if start_frame >= t:                 # the whole recording was calibrated
        return head if return_aux else head[0]
    rest = predict_framewise(
        quantize_convs(model, min_kernel_elems, scales, exclude), x,
        context=context, batch_size=batch_size, compression=None,
        group=group, start_frame=start_frame, **predict_kwargs)
    if not start_frame:
        return rest
    if return_aux:
        return tuple(torch.cat(pair) for pair in zip(head, rest))
    return torch.cat([head[0], rest])
