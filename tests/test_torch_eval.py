"""The port's windowed inference protocol and the whole serving slice
(audio -> HCQT -> SAUnet -> framewise salience) against the JAX package
and its committed protocol golden, on the CPU."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multipitch_architectures_tpu.dsp.hcqt import efficient_hcqt_device
from multipitch_architectures_tpu.eval.inference import \
    predict_framewise as j_predict_framewise
from multipitch_architectures_tpu.models import \
    SimpleUNetDoubleSelfAttn as JSAUnet
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.dsp import hcqt
from multipitch_architectures_tpu_torch.eval import predict_framewise
from multipitch_architectures_tpu_torch.eval.inference import (
    _next_batch_size, _pad_inputs)
from multipitch_architectures_tpu_torch.models import (
    SimpleUNetDoubleSelfAttn, state_dict_from_flax)

TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=16,
            embed_dim=32, num_heads=8, mlp_dim=64, pos_encoding="sinusoidal")


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "predict_framewise_golden.npz"))
    variables = serialization.msgpack_restore(g["variables_msgpack"].tobytes())
    return g, variables


def _model(variables, **kw):
    m = SimpleUNetDoubleSelfAttn(**TINY, **kw).eval()
    m.load_state_dict(state_dict_from_flax(variables), strict=True)
    return m


def _drain(t, batch_size, group):
    sizes = []
    while t > 0:
        sizes.append(_next_batch_size(t, batch_size, group))
        t -= sizes[-1]
    return sizes


def test_batch_drain_order():
    """Full batches, then the tail's full groups, then the natural-size
    remainder (the reference loader's last short batch)."""
    assert _drain(57, 20, 10) == [20, 20, 10, 7]
    assert _drain(431, 250, 50) == [250, 150, 31]
    assert _drain(57, 10, None) == [10] * 5 + [7]


def test_predict_framewise_matches_committed_golden(golden):
    """The JAX package's protocol golden (tests/goldens, exact msgpack
    variables, fixed HCQT), plain batches of 10 and fused batches of 20 in
    groups of 10: atol 2e-5, rtol 1e-5, as tests/test_eval.py holds the
    JAX package to it."""
    g, variables = golden
    batch, group = int(g["batch"]), int(g["group"])
    inputs = torch.from_numpy(g["inputs"])
    plain = predict_framewise(_model(variables), inputs, batch_size=group)
    grouped = predict_framewise(
        _model(variables, attn_mode=f"cross_batch:{group}"), inputs,
        batch_size=batch, group=group)
    assert plain.shape == grouped.shape == (57, 72)
    np.testing.assert_allclose(plain.numpy(), g["pred_plain"], atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(grouped.numpy(), g["pred_grouped"],
                               atol=2e-5, rtol=1e-5)


def test_predict_framewise_checks_its_arguments(golden):
    g, variables = golden
    model = _model(variables)
    x = torch.from_numpy(g["inputs"])
    with pytest.raises(ValueError, match="multiple"):
        predict_framewise(model, x, batch_size=25, group=10)
    with pytest.raises(ValueError, match="eval mode"):
        predict_framewise(model.train(), x)
    assert _pad_inputs(x, 75).shape == (6, 57 + 75, 216)


def test_serving_slice_matches_jax(golden):
    """3 s of audio -> HCQT (hop 512, 36 bins per octave) -> tiny SAUnet
    with ``cross_batch:10`` attention in fused batches of 20 -> (130, 72).
    atol 1e-4 (measured max gap 8.3e-7, torch 2.13 against JAX 0.9, both
    on the CPU)."""
    _, variables = golden
    fs = 22050
    t = np.arange(3 * fs) / fs
    audio = sum((1.0 / h) * np.sin(2 * np.pi * 261.63 * h * t)
                for h in (1, 2, 3, 4, 5))
    audio = (audio + 1e-3 * np.random.RandomState(0).randn(len(t))).astype(
        np.float32)
    kw = dict(fs=fs, fs_hcqt_target=50, bins_per_octave=36, num_octaves=6,
              tuning=0.0)

    f_jax = efficient_hcqt_device(audio, **kw)[0]
    jm = dataclasses.replace(JSAUnet(**TINY), attn_mode="cross_batch:10")
    want = j_predict_framewise(
        lambda v, xw: jm.apply(v, xw, train=False), variables,
        jnp.asarray(f_jax), batch_size=20, group=10)

    f = hcqt(audio, **kw)[0]
    got = predict_framewise(_model(variables, attn_mode="cross_batch:10"), f,
                            batch_size=20, group=10)
    assert got.shape == want.shape == (130, 72)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
