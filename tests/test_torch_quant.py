"""The port's int8 (W8A8) serving mode against the JAX package's, on the
CPU: the exact int8 products, the quantized conv, calibration, the
quantized forward, ``predict_framewise_int8`` and the drift gate. A tiny
SAUnet with the JAX model's weights bridged into the port; JAX int8
programs are few and module-scoped (XLA:CPU compiles quantized attention
U-Nets slowly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.eval import quant as jquant
from multipitch_architectures_tpu.eval.inference import \
    _pad_inputs as j_pad_inputs
from multipitch_architectures_tpu.models import \
    SimpleUNetDoubleSelfAttn as JSAUnet
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.data import gather_windows
from multipitch_architectures_tpu_torch.eval import (
    auto_hybrid_int8, calibrate_activation_scales, eligible_convs,
    percentile_abs, predict_framewise, predict_framewise_int8,
    quantize_convs, quantized_conv, quantized_conv_static)
from multipitch_architectures_tpu_torch.eval import quant as tquant
from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs
from multipitch_architectures_tpu_torch.experiments import load_experiment
from multipitch_architectures_tpu_torch.models import (
    SimpleUNetDoubleSelfAttn, state_dict_from_flax, torch_module_name)
from multipitch_architectures_tpu_torch.ops.int8_gemm import (
    int8_conv2d, int8_conv2d_reference, int8_mm, int8_mm_reference)
from multipitch_architectures_tpu_torch.utils import counters
from test_torch_zoo import CASES as ZOO_CASES
from test_torch_zoo import seeded_variables

TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=16,
            embed_dim=32, num_heads=8, mlp_dim=64)
CROSS_PROGRAM = 5e-3   # int8 outputs of two programs: bin-flip noise


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its variables, the port's model with those weights)."""
    jm = JSAUnet(**TINY)
    variables = jm.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 6, 75, 216)), train=False)
    tm = SimpleUNetDoubleSelfAttn(**TINY).eval()
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def windows():
    return np.random.RandomState(3).rand(2, 6, 75, 216).astype(np.float32)


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("n,h,w,c,cout,kernel,stride,pad", [
    (2, 11, 20, 6, 5, (5, 5), (1, 1), (2, 2)),       # inc's Cin of 6
    (2, 7, 24, 8, 6, (3, 3), (1, 3), (1, 0)),        # the head's conv2
    (2, 75, 6, 10, 4, (75, 1), (1, 1), (0, 0)),      # the head's conv3
    (3, 1, 12, 10, 7, (1, 1), (1, 1), (0, 0)),       # the head's conv4
])
def test_int8_conv2d_reference_is_lax_conv(n, h, w, c, cout, kernel, stride,
                                           pad):
    """The exact int8 conv, bit-equal to the JAX package's
    ``conv_general_dilated(int8, int8, preferred_element_type=int32)``."""
    rng = np.random.RandomState(0)
    xq, wq = _int8(rng, n, h, w, c), _int8(rng, cout, *kernel, c)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq.transpose(1, 2, 3, 0)), stride,
        ((pad[0], pad[0]), (pad[1], pad[1])),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    for fn in (int8_conv2d_reference, int8_conv2d):
        got = fn(torch.from_numpy(xq), torch.from_numpy(wq), stride, pad)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(7, 33, 5), (64, 1350, 32),
                                   (3, 15000, 2)])
def test_int8_mm_reference_is_exact(m, k, n):
    rng = np.random.RandomState(1)
    a, b = _int8(rng, m, k), _int8(rng, k, n)
    want = a.astype(np.int64) @ b.astype(np.int64)
    for fn in (int8_mm_reference, int8_mm):
        got = fn(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_wrappers_check_their_arguments():
    """Wrong types and shapes raise; on the CPU the wrappers take the
    plain versions and count no launch."""
    x8 = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    w8 = torch.zeros((2, 3, 3, 16), dtype=torch.int8)
    with pytest.raises(TypeError):
        int8_conv2d(x8.float(), w8)
    with pytest.raises(ValueError):
        int8_conv2d(x8, w8[..., :8])
    with pytest.raises(ValueError, match="empty"):
        int8_conv2d(x8, torch.zeros((2, 5, 5, 16), dtype=torch.int8))
    with pytest.raises(ValueError):
        int8_mm(x8[0, 0], w8[0, 0])
    with pytest.raises(TypeError):
        int8_mm(x8[0, 0].float(), x8[0, 0].T.float())
    launches = ("int8.conv_launches", "int8.mm_launches")
    before = [counters[k] for k in launches]
    int8_conv2d(x8, w8, (1, 1), (1, 1))
    int8_mm(x8[0, 0], x8[0, 0].T.contiguous())
    assert [counters[k] for k in launches] == before


def _capture_jax(monkeypatch, fn, *args):
    """Run the JAX package's quantized conv eagerly and capture the int8
    operands it hands to ``conv_general_dilated``."""
    seen = {}
    conv = jax.lax.conv_general_dilated

    def capture(xq, wq, *a, **kw):
        seen["xq"], seen["wq"] = np.asarray(xq), np.asarray(wq)
        return conv(xq, wq, *a, **kw)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", capture)
    y = np.asarray(fn(*args))
    monkeypatch.setattr(jax.lax, "conv_general_dilated", conv)
    return seen, y


def _capture_port(monkeypatch, fn, *args):
    seen = {}
    conv = tquant.int8_conv2d_dequant

    def capture(xq, wq, *a, **kw):
        seen["xq"], seen["wq"] = xq.numpy(), wq.numpy()
        return conv(xq, wq, *a, **kw)

    monkeypatch.setattr(tquant, "int8_conv2d_dequant", capture)
    y = fn(*args).numpy()
    monkeypatch.setattr(tquant, "int8_conv2d_dequant", conv)
    return seen, y


@pytest.mark.parametrize("mode", ["dynamic", "per_tensor", "per_channel"])
def test_quantized_conv_matches_jax(monkeypatch, mode):
    """The int8 activation and weights are bit-equal to the JAX package's
    (same rounding, division and scale order); the dequantized outputs
    agree within 1e-6."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 15, 30, 6) * [[[[3.0, 1.0, 0.5, 0.2, 0.1, 0.02]]]]
         ).astype(np.float32)                                  # NHWC
    kernel = (rng.randn(5, 5, 6, 8) * 0.1).astype(np.float32)  # HWIO
    bias = (rng.randn(8) * 0.1).astype(np.float32)
    stride, pad = (1, 3), (2, 1)
    jpad = ((pad[0], pad[0]), (pad[1], pad[1]))
    scale = {"per_tensor": float(np.abs(x).max()) * 0.9 / 127.0,
             "per_channel": (np.abs(x).max(axis=(0, 1, 2)) * 0.9 / 127.0
                             ).astype(np.float32)}.get(mode)
    jargs = (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), stride,
             jpad)
    targs = (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
             torch.from_numpy(bias), stride, pad)
    if scale is None:
        want, y_j = _capture_jax(monkeypatch, jquant.quantized_conv, *jargs)
        got, y_t = _capture_port(monkeypatch, quantized_conv, *targs)
    else:
        want, y_j = _capture_jax(monkeypatch, jquant.quantized_conv_static,
                                 *jargs, scale)
        got, y_t = _capture_port(monkeypatch, quantized_conv_static, *targs,
                                 scale)
    np.testing.assert_array_equal(got["xq"], want["xq"])
    np.testing.assert_array_equal(got["wq"], want["wq"].transpose(3, 0, 1, 2))
    assert np.abs(got["xq"]).max() == 127
    np.testing.assert_allclose(y_t.transpose(0, 2, 3, 1), y_j, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("per_channel", [False, True])
def test_calibrated_scales_match_jax(tiny, windows, per_channel):
    """Calibration captures the same convs (the JAX package's module
    paths through ``torch_module_name``) and the same scales, within
    1e-5 of each conv's largest scale: a scale is the max of an upstream
    float32 activation, which the two frameworks sum in different orders
    (measured: 1.2e-6 relative on a per-tensor scale, 6.4e-10 absolute on
    a small channel's)."""
    jm, variables, tm = tiny
    want = jquant.calibrate_activation_scales(
        jm, variables, [jnp.asarray(windows)], per_channel=per_channel)
    got = calibrate_activation_scales(tm, [torch.from_numpy(windows)],
                                      per_channel=per_channel)
    assert set(got) == {torch_module_name(k) for k in want}
    assert set(got) == {name for name, _ in eligible_convs(tm)}
    for k, v in want.items():
        g = got[torch_module_name(k)]
        assert g.dtype == torch.float32 and g.dim() == (1 if per_channel
                                                        else 0)
        np.testing.assert_allclose(g.numpy(), v, rtol=0,
                                   atol=1e-5 * np.abs(v).max())


def test_torch_module_name_and_the_exp180e_conv_set():
    """The JAX package's paths map onto the port's conv names, and
    exp180e at full width quantizes 21 convs (every conv but the
    150-weight ``conv4.3``) at the default ``min_kernel_elems``."""
    assert [torch_module_name(p) for p in (
        "inc/conv1", "inc/conv2", "down3/conv2", "upconv4/conv1",
        "head/conv2/conv", "head/conv3/conv", "head/conv4/conv",
        "head/conv5")] == [
        "inc.double_conv.0", "inc.double_conv.4", "down3.1.double_conv.4",
        "upconv4.double_conv.0", "conv2.0", "conv3.0", "conv4.0", "conv4.3"]
    assert torch_module_name(("inc", "conv2"), convdrop=None) == \
        "inc.double_conv.3"
    with pytest.raises(KeyError):
        torch_module_name("attention1/q_linear")
    model = load_experiment(
        "exp180e_musicnet_unet_insanelylarge_doubleselfattn").build_model()
    names = [name for name, _ in eligible_convs(model)]
    convs = [name for name, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert len(names) == 21 and set(convs) - set(names) == {"conv4.3"}


def test_quantized_forward_matches_jax(tiny, windows):
    """With the same scales the quantized forward is within the
    cross-program bound of the JAX package's ``quantized_apply_fn`` and
    differs from float32; excluding every conv gives the port's float32
    forward exactly."""
    jm, variables, tm = tiny
    jscales = jquant.calibrate_activation_scales(jm, variables,
                                                 [jnp.asarray(windows)])
    want = np.asarray(jax.jit(jquant.quantized_apply_fn(
        jm, activation_scales=jscales))(variables, jnp.asarray(windows)))
    scales = {torch_module_name(k): torch.tensor(v, dtype=torch.float32)
              for k, v in jscales.items()}
    x = torch.from_numpy(windows)
    with torch.no_grad():
        f32 = tm(x).numpy()
        got = quantize_convs(tm, activation_scales=scales)(x).numpy()
        all_f32 = quantize_convs(tm, activation_scales=scales,
                                 exclude=tuple(scales))(x).numpy()
    np.testing.assert_allclose(got, want, atol=CROSS_PROGRAM, rtol=0)
    assert np.abs(got - f32).max() > 1e-5
    np.testing.assert_array_equal(all_f32, f32)
    assert all(isinstance(m, torch.nn.Conv2d) for _, m in eligible_convs(tm))


def test_predict_framewise_int8_matches_jax(tiny):
    """As tests/test_eval.py holds the JAX package: the calibration span
    (two full batches of 25) is the float32 protocol, the rest int8."""
    jm, variables, tm = tiny
    inputs = np.random.RandomState(7).rand(6, 60, 216).astype(np.float32)
    want = jquant.predict_framewise_int8(jm, variables, inputs,
                                         batch_size=25, cal_batches=2)
    got = predict_framewise_int8(tm, torch.from_numpy(inputs),
                                 batch_size=25, cal_batches=2)
    f32 = predict_framewise(tm, torch.from_numpy(inputs), batch_size=25)
    assert got.shape == (60, 72)
    np.testing.assert_allclose(got[:50].numpy(), want[:50], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got[50:].numpy(), want[50:],
                               atol=CROSS_PROGRAM, rtol=0)
    np.testing.assert_array_equal(got[:50].numpy(), f32[:50].numpy())
    assert (got[50:] - f32[50:]).abs().max() > 1e-5


def _manual(tm, inputs, centers_per_batch, batch_size, start_frame=0):
    """calibrate -> quantize_convs -> predict_framewise, by hand."""
    xp = _pad_inputs(torch.log1p(10.0 * inputs), 75)
    cal = [gather_windows(xp, 37 + c, 75) for c in centers_per_batch]
    q = quantize_convs(tm, activation_scales=calibrate_activation_scales(
        tm, cal))
    return predict_framewise(q, inputs, batch_size=batch_size,
                             start_frame=start_frame)


def test_predict_framewise_int8_compositions(tiny):
    """The one-call serve equals its hand-made composition: a recording
    that the calibration covers is the float32 protocol; a short one
    calibrates on clipped windows and runs int8 throughout; without
    reuse the calibration span is int8 too; with ``group`` the full
    calibration batches fuse into one forward."""
    _, _, tm = tiny
    rng = np.random.RandomState(8)
    inputs = torch.from_numpy(rng.rand(6, 60, 216).astype(np.float32))
    covered = predict_framewise_int8(tm, inputs[:, :50], batch_size=25,
                                     cal_batches=2)
    np.testing.assert_array_equal(
        covered.numpy(), predict_framewise(tm, inputs[:, :50],
                                           batch_size=25).numpy())
    short = predict_framewise_int8(tm, inputs[:, :20], batch_size=25,
                                   cal_batches=2)
    np.testing.assert_array_equal(short.numpy(), _manual(
        tm, inputs[:, :20], [np.minimum(np.arange(25), 19)], 25).numpy())
    all_int8 = predict_framewise_int8(tm, inputs, batch_size=25,
                                      cal_batches=2,
                                      reuse_cal_predictions=False)
    np.testing.assert_array_equal(all_int8.numpy(), _manual(
        tm, inputs, [np.arange(25), 25 + np.arange(25)], 25).numpy())
    grouped = SimpleUNetDoubleSelfAttn(**TINY, attn_mode="cross_batch:25")
    grouped.load_state_dict(tm.state_dict())
    fused = predict_framewise_int8(grouped.eval(), inputs, batch_size=50,
                                   group=25, cal_batches=1)
    np.testing.assert_array_equal(fused[50:].numpy(), _manual(
        grouped, inputs, [np.arange(50)], 50, start_frame=50).numpy())


def test_auto_hybrid_int8_extremes(tiny, windows):
    """An impossible gate demotes every conv and reproduces float32
    exactly with zero drift; a generous one demotes nothing."""
    _, _, tm = tiny
    cal = [torch.from_numpy(windows[:1]), torch.from_numpy(windows[1:])]
    policy, report = auto_hybrid_int8(tm, cal, gate=-1.0)
    assert not policy["activation_scales"]
    assert set(policy["exclude"]) == {n for n, _ in eligible_convs(tm)}
    with torch.no_grad():
        np.testing.assert_array_equal(
            quantize_convs(tm, **policy)(cal[0]).numpy(), tm(cal[0]).numpy())
    assert report["worst"] == 0.0 and report["pred_max"] == 0.0
    policy, report = auto_hybrid_int8(tm, cal, gate=10.0)
    assert report["passed"] and not policy["exclude"]
    assert set(policy["activation_scales"]) == {n for n, _ in
                                                eligible_convs(tm)}


def test_gate_verify_windows_cover_the_whole_protocol():
    """The gate verifies on the protocol's own batching of the whole
    recording, every frame once, as the JAX package's does."""
    t, bs = 130, 50
    x = np.random.RandomState(0).rand(6, t, 216).astype(np.float32)
    got = tquant._gate_verify_windows(_pad_inputs(torch.from_numpy(x), 75),
                                      t, bs, 75)
    want = jquant._gate_verify_windows(j_pad_inputs(jnp.asarray(x), 75), t,
                                       bs, 75)
    assert [int(w.shape[0]) for w in got] == [50, 50, 30]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gated_serve_with_a_ragged_grouped_tail_raises(tiny, monkeypatch):
    """The JAX package's gate batches its verification windows by
    ``batch_size`` and ignores ``group``: with ``batch_size`` > ``group``
    its set ends in a tail of 15 windows, which raises in groups of 10.
    The port's set drains as the protocol does (20, then the tail's full
    group of 10, then 5), so the gated serve serves, and its drift report
    reads each frame once, in order."""
    _, _, tm = tiny
    grouped = SimpleUNetDoubleSelfAttn(**TINY, attn_mode="cross_batch:10")
    grouped.load_state_dict(tm.state_dict())
    x = np.random.RandomState(9).rand(6, 35, 216).astype(np.float32)
    theirs = jquant._gate_verify_windows(j_pad_inputs(jnp.asarray(x), 75),
                                         35, 20, 75)
    assert [int(w.shape[0]) for w in theirs] == [20, 15]
    with pytest.raises(ValueError, match="not a multiple of attention"), \
            torch.no_grad():
        grouped.eval()(torch.from_numpy(np.array(theirs[-1])))
    seen = []
    search = tquant.auto_hybrid_int8

    def recording(*args, verify_windows=None, **kw):
        seen.extend(verify_windows)
        return search(*args, verify_windows=verify_windows, **kw)

    monkeypatch.setattr(tquant, "auto_hybrid_int8", recording)
    pred = predict_framewise_int8(grouped.eval(), torch.from_numpy(x),
                                  batch_size=20, group=10, cal_batches=1,
                                  gate=1e-3)
    assert pred.shape == (35, 72) and bool(torch.isfinite(pred).all())
    assert [int(w.shape[0]) for w in seen] == [20, 10, 5]
    xp = _pad_inputs(torch.log1p(10.0 * torch.from_numpy(x)), 75)
    np.testing.assert_array_equal(
        torch.cat(seen).numpy(),
        gather_windows(xp, 37 + np.arange(35), 75).numpy())


@pytest.mark.parametrize("t,batch,group", [
    (130, 50, None), (130, 50, 50), (120, 50, 10), (105, 50, 10),
    (431, 250, None)])
def test_gate_verify_windows_equal_jax_where_jax_serves(t, batch, group):
    """Without a group, with the group equal to the batch, and with a
    tail that is a multiple of the group or shorter than it, the JAX
    package's set serves, and the port's is the same."""
    x = np.random.RandomState(1).rand(6, t, 216).astype(np.float32)
    got = tquant._gate_verify_windows(_pad_inputs(torch.from_numpy(x), 75),
                                      t, batch, 75, group)
    want = jquant._gate_verify_windows(j_pad_inputs(jnp.asarray(x), 75), t,
                                       batch, 75)
    assert [int(w.shape[0]) for w in got] == \
        [int(w.shape[0]) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gated_serve_of_a_10s_request_at_batch_250_group_50(tiny):
    """A 10-s request (431 frames; tail 181) at the serving protocol's
    batch 250 and group 50 with the gate on: the JAX package's
    verification set would end in a batch of 181, which grouped attention
    rejects; the port's set drains it as 150 + 31 and the serve answers."""
    _, _, tm = tiny
    grouped = SimpleUNetDoubleSelfAttn(**TINY, attn_mode="cross_batch:50")
    grouped.load_state_dict(tm.state_dict())
    x = torch.from_numpy(
        np.random.RandomState(10).rand(6, 431, 216).astype(np.float32))
    pred = predict_framewise_int8(grouped.eval(), x, batch_size=250,
                                  group=50, cal_batches=1, gate=1e-3)
    assert pred.shape == (431, 72) and bool(torch.isfinite(pred).all())
    assert 0.0 <= float(pred.min()) <= float(pred.max()) <= 1.0


@pytest.mark.parametrize("per_channel", [False, True])
def test_percentile_abs_is_jnp_percentile(per_channel):
    """``percentile_abs`` is ``jnp.percentile`` of |x| (linear
    interpolation, per channel of an NCHW tensor with ``per_channel``) on
    the same float32 array, compiled with the percentile a constant as
    the JAX package's calibration probe compiles it: the same order
    statistics, the interpolation rounded as in float32 (1e-6
    relative)."""
    for shape in ((3, 4, 7, 11), (2, 6, 75, 216)):     # the latter: inc's
        x = np.random.RandomState(5).randn(*shape).astype(np.float32)
        a = jnp.abs(jnp.asarray(x.transpose(0, 2, 3, 1)))      # NHWC
        for q in (99.9, 50.0, 0.0, 100.0, 37.3):
            want = np.asarray(jax.jit(
                lambda a: jnp.percentile(a, q, axis=(0, 1, 2)) if per_channel
                else jnp.percentile(a, q))(a))
            got = percentile_abs(torch.from_numpy(x), q, per_channel).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=f"{shape} {q}")


def test_percentile_abs_beyond_torch_quantile_limit():
    """More than 2^24 elements, where ``torch.quantile`` refuses (a
    full-width ``inc`` input of a batch of 250 holds 24.3 M): the value
    of ``np.percentile`` in float64, up to the float32 position's
    rounding (n - 1 = 16,781,311 is not a float32: the position may move
    to a neighbouring order statistic, 1.2e-6 relative here)."""
    x = torch.from_numpy(np.random.RandomState(6).randn(
        1, 1, 2 ** 12 + 1, 2 ** 12).astype(np.float32))
    with pytest.raises(RuntimeError):
        torch.quantile(x.abs().reshape(-1), 0.999)
    a = np.abs(x.numpy()).astype(np.float64)
    for q, per_channel in ((99.9, False), (99.9, True), (0.1, False)):
        got = float(percentile_abs(x, q, per_channel))
        want = np.percentile(a, q)
        assert abs(got - want) <= 1e-5 * want, (q, per_channel)


@pytest.mark.parametrize("per_channel", [False, True])
def test_percentile_scales_match_jax(tiny, windows, per_channel):
    """``calibrate_activation_scales(percentile=99.9)`` against the JAX
    package's, through ``torch_module_name``; and below the max
    calibration's scales. Per tensor within 1e-6 relative. Per channel
    each scale interpolates between order statistics of a few thousand
    values of a float32 activation that the two frameworks compute in
    different orders (2.1e-6 relative measured on ``down1``'s second
    conv), so it is held as the max calibration is (1e-5 of the conv's
    largest scale); on the same array the percentile itself agrees to
    1e-6 (``test_percentile_abs_is_jnp_percentile``)."""
    jm, variables, tm = tiny
    want = jquant.calibrate_activation_scales(
        jm, variables, [jnp.asarray(windows)], percentile=99.9,
        per_channel=per_channel)
    got = calibrate_activation_scales(tm, [torch.from_numpy(windows)],
                                      percentile=99.9,
                                      per_channel=per_channel)
    top = calibrate_activation_scales(tm, [torch.from_numpy(windows)],
                                      per_channel=per_channel)
    assert set(got) == {torch_module_name(k) for k in want}
    for k, v in want.items():
        name = torch_module_name(k)
        if per_channel:
            np.testing.assert_allclose(got[name].numpy(), v, rtol=0,
                                       atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[name].numpy(), v, rtol=1e-6,
                                       atol=0, err_msg=k)
        assert bool((got[name] <= top[name]).all())


def test_predict_framewise_int8_return_aux_matches_jax():
    """The PUnet in the int8 mode with ``return_aux``, against the JAX
    package's: the calibration span's rows (main and aux) are the float32
    calibration pass's, the rest the int8 pass's (5e-3 between the two
    programs). Three quantized convs: XLA:CPU compiles each slowly."""
    jm, v, tm = _zoo_pair("punet")
    inputs = np.random.RandomState(8).rand(6, 13, 216).astype(np.float32)
    kw = dict(batch_size=8, cal_batches=1, min_kernel_elems=16384)
    want, want_aux = jquant.predict_framewise_int8(jm, v, inputs,
                                                   return_aux=True, **kw)
    got, aux = predict_framewise_int8(tm, torch.from_numpy(inputs),
                                      return_aux=True, **kw)
    f32, f32_aux = predict_framewise(tm, torch.from_numpy(inputs),
                                     batch_size=8, return_aux=True)
    assert got.shape == (13, 72) and aux.shape == want_aux.shape == (13, 24)
    np.testing.assert_array_equal(got[:8].numpy(), f32[:8].numpy())
    np.testing.assert_array_equal(aux[:8].numpy(), f32_aux[:8].numpy())
    assert float((aux[8:] - f32_aux[8:]).abs().max()) > 0
    np.testing.assert_allclose(aux[:8].numpy(), want_aux[:8], atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(aux[8:].numpy(), want_aux[8:],
                               atol=CROSS_PROGRAM * np.abs(want_aux).max(),
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=CROSS_PROGRAM, rtol=0)
    only = predict_framewise_int8(tm, torch.from_numpy(inputs), **kw)
    np.testing.assert_array_equal(only.numpy(), got.numpy())


def _zoo_pair(name):
    """(JAX model, seeded variables, the port's model with them) of one
    family of tests/test_torch_zoo.py's tiny cases."""
    jcls, tcls, kw, _, *gain = ZOO_CASES[name]
    jm = jcls(**kw)
    v = seeded_variables(jm, np.zeros((1, 6, 75, 216), np.float32),
                         sorted(ZOO_CASES).index(name), *gain, train=False)
    tm = tcls(**kw).eval()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, tm


def _flax_conv_paths(params, prefix=()):
    """[(flax module path, HWIO kernel)] of every conv in ``params``."""
    out = []
    for k, p in params.items():
        if isinstance(p, dict):
            if "kernel" in p and np.ndim(p["kernel"]) == 4:
                out.append(("/".join(prefix + (k,)), np.asarray(p["kernel"])))
            else:
                out += _flax_conv_paths(p, prefix + (k,))
    return out


@pytest.mark.parametrize("name", ["cnn", "drcnn", "unet", "sausnet_residual",
                                  "blunet_depth1", "punet"])
def test_torch_module_name_covers_every_family(name):
    """Each JAX conv path of one tiny model per family maps to the port's
    ``nn.Conv2d`` that holds its kernel, every conv of the port is
    reached, and a JAX-keyed scale reaches the quantized conv of the same
    path."""
    jm, v, tm = _zoo_pair(name)
    paths = _flax_conv_paths(v["params"])
    names = {}
    for path, kernel in paths:
        conv = tm.get_submodule(torch_module_name(path))
        assert isinstance(conv, torch.nn.Conv2d), path
        np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                      kernel.transpose(3, 2, 0, 1),
                                      err_msg=path)
        names[path] = torch_module_name(path)
    assert sorted(names.values()) == sorted(
        n for n, m in tm.named_modules() if isinstance(m, torch.nn.Conv2d))
    jax_scales = {path: float(i + 1) for i, (path, _) in enumerate(paths)}
    scales = {names[k]: torch.tensor(s) for k, s in jax_scales.items()}
    q = quantize_convs(tm, 1, scales)
    for path, s in jax_scales.items():
        m = q.get_submodule(names[path])
        if type(m).__name__ == "Int8Conv2d":
            assert float(m.activation_scales[m.name]) == s
            assert m.weight is tm.get_submodule(names[path]).weight
