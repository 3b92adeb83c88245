"""The int8 GEMM's fused-dequantize entry and its channel padding, on the
CPU (plain versions): the fused entry equals the int32 sums followed by
the unfused float32 passes bit for bit, and the quantized convs of the
int8 mode give what the unfused passes gave."""

import numpy as np
import pytest
import torch

from multipitch_architectures_tpu_torch.eval import quant
from multipitch_architectures_tpu_torch.ops.int8_gemm import (
    int8_conv2d, int8_conv2d_dequant, int8_conv2d_dequant_reference,
    int8_conv2d_reference, pad_channels)
from multipitch_architectures_tpu_torch.utils import counters

MODES = ["dynamic", "per_tensor", "per_channel"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread (see test_torch_ops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int8(rng, *shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


def _scales(rng, mode, cout):
    """(s1, s2) as the int8 mode maps its three modes onto the fused
    entry, and the unfused passes it made before: a list of (Cout,) or
    0-dim float32 factors, applied in order."""
    ws = torch.from_numpy((rng.rand(cout) * 1e-3 + 1e-5).astype(np.float32))
    xs = torch.tensor(float(rng.rand() * 0.1 + 1e-3), dtype=torch.float32)
    one = torch.tensor(1.0)
    if mode == "dynamic":
        return (ws * xs, one), [ws * xs]
    if mode == "per_tensor":
        return (ws, xs), [ws, xs]
    return (ws, one), [ws]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_dequant_reference_is_the_unfused_passes(mode, with_bias):
    rng = np.random.RandomState(MODES.index(mode))
    xq, wq = _int8(rng, 2, 9, 14, 16), _int8(rng, 24, 3, 5, 16)
    (s1, s2), passes = _scales(rng, mode, 24)
    bias = (torch.from_numpy(rng.randn(24).astype(np.float32))
            if with_bias else None)
    want = int8_conv2d_reference(xq, wq, (1, 2), (1, 2)).float()
    for factor in passes:
        want.mul_(factor)
    if bias is not None:
        want.add_(bias)
    for fn in (int8_conv2d_dequant_reference, int8_conv2d_dequant):
        got = fn(xq, wq, (1, 2), (1, 2), s1, s2, bias)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


def _unfused_quantized_conv(x, weight, bias, stride, padding, x_scale=None):
    """The int8 mode's quantized conv as it was before the dequantize was
    fused: int32 sums, then float32 passes over them."""
    if x_scale is None:
        ws = quant._weight_scales(weight)
        wq = quant._quantize(weight, ws[:, None, None, None])
        xs = torch.clamp_min(x.abs().amax(), 1e-12) / quant._constant(
            quant.QMAX, x)
        xq, factors = quant._quantize(x, xs), [ws * xs]
    else:
        xs = torch.as_tensor(x_scale, dtype=torch.float32)
        if xs.dim() == 1:
            weight = weight * xs[None, :, None, None]
        ws = quant._weight_scales(weight)
        wq = quant._quantize(weight, ws[:, None, None, None])
        xq = quant._quantize(x, xs if xs.dim() == 0
                             else xs[None, :, None, None])
        factors = [ws, xs] if xs.dim() == 0 else [ws]
    y = int8_conv2d(xq.permute(0, 2, 3, 1).contiguous(),
                    wq.permute(0, 2, 3, 1).contiguous(), stride,
                    padding).float()
    for factor in factors:
        y.mul_(factor)
    if bias is not None:
        y.add_(bias)
    return y.permute(0, 3, 1, 2)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_quantized_convs_equal_the_unfused_passes(mode, with_bias):
    """On the CPU, the int8 mode's convs through the fused entry give the
    unfused passes' output bit for bit, channels-last view and all."""
    rng = np.random.RandomState(10 + MODES.index(mode))
    x = torch.from_numpy((rng.randn(2, 6, 15, 30)
                          * rng.rand(1, 6, 1, 1) * 3).astype(np.float32))
    weight = torch.from_numpy((rng.randn(8, 6, 5, 5) * 0.1)
                              .astype(np.float32))
    bias = (torch.from_numpy((rng.randn(8) * 0.1).astype(np.float32))
            if with_bias else None)
    stride, pad = (1, 3), (2, 1)
    if mode == "dynamic":
        got = quant.quantized_conv(x, weight, bias, stride, pad)
        want = _unfused_quantized_conv(x, weight, bias, stride, pad)
    else:
        scale = (float(x.abs().max()) * 0.9 / 127.0 if mode == "per_tensor"
                 else (x.abs().amax(dim=(0, 2, 3)) * 0.9 / 127.0).numpy())
        got = quant.quantized_conv_static(x, weight, bias, stride, pad, scale)
        want = _unfused_quantized_conv(x, weight, bias, stride, pad, scale)
    assert got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got, want)


def _bad_dequant_args():
    f32 = dict(dtype=torch.float32)
    s1, s2, bias = torch.ones(4, **f32), torch.tensor(1.0), torch.zeros(4)
    return {
        "s1 shape": (ValueError, (torch.ones(5, **f32), s2, bias)),
        "s2 not 0-dim": (ValueError, (s1, torch.ones(1, **f32), bias)),
        "s1 dtype": (TypeError, (s1.double(), s2, bias)),
        "bias dtype": (TypeError, (s1, s2, bias.half())),
        "bias shape": (ValueError, (s1, s2, torch.zeros(3, **f32))),
        "mixed devices": (ValueError, (s1.to("meta"), s2, bias)),
    }


@pytest.mark.parametrize("case", list(_bad_dequant_args()))
def test_dequant_checks_its_arguments(case):
    """Wrong scales or bias raise before anything runs; a good call on the
    CPU takes the plain version and counts no launch."""
    xq = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    wq = torch.zeros((4, 3, 3, 16), dtype=torch.int8)
    error, args = _bad_dequant_args()[case]
    before = counters["int8.conv_dequant_launches"]
    with pytest.raises(error):
        int8_conv2d_dequant(xq, wq, (1, 1), (1, 1), *args)
    int8_conv2d_dequant(xq, wq, (1, 1), (1, 1), torch.ones(4),
                        torch.tensor(2.0))
    assert counters["int8.conv_dequant_launches"] == before


@pytest.mark.parametrize("cin,padded", [(6, 8), (8, 8), (16, 16), (20, 32)])
def test_padded_channels_keep_the_sums(cin, padded):
    """The kernel's channel padding (8 for the 6-channel first conv, else
    a multiple of 16) adds zeros that change no sum."""
    rng = np.random.RandomState(cin)
    xq, wq = _int8(rng, 2, 11, 20, cin), _int8(rng, 5, 5, 5, cin)
    xp, wp = pad_channels(xq, wq)
    assert xp.shape[3] == wp.shape[3] == padded
    assert torch.equal(xp[..., :cin], xq) and not xp[..., cin:].any()
    assert torch.equal(int8_conv2d_reference(xp, wp, (1, 1), (2, 2)),
                       int8_conv2d_reference(xq, wq, (1, 1), (2, 2)))
