"""The port's shared-``inc`` forward (``eval/shared_inc.py``) on the CPU:
against the JAX package's ``predict_framewise_shared`` on the same
weights (1e-4), against the port's own windowed protocol (2e-5, the JAX
package's bound) with plain and grouped attention, the natural tail and
residual down blocks, with the PUnet's aux head, and in the int8 mode
against the JAX package's (5e-3, the bin-flip noise of two programs);
what changes or lacks ``inc`` is refused as the JAX package refuses it.

Small recordings keep the protocol's drain: batch 10 and group 5 give
full batches, a grouped tail of full groups and a natural remainder as
the tests of the JAX package do at batch 50 and group 25.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo import seeded_variables

from multipitch_architectures_tpu.eval import quant as jquant
from multipitch_architectures_tpu.eval import shared_inc as jshared
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.eval import (
    Int8Conv2d, SharedIncForward, eligible_convs, predict_framewise,
    predict_framewise_shared)
from multipitch_architectures_tpu_torch.models import (state_dict_from_flax,
                                                       torch_module_name)

TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=16)
TINY_ATTN = dict(TINY, embed_dim=32, num_heads=8, mlp_dim=64,
                 pos_encoding="sinusoidal")
JAX_TOL = 1e-4          # the port against the JAX package
PROTOCOL_TOL = 2e-5     # shared against windowed (the JAX package's bound)
CROSS_PROGRAM = 5e-3    # int8 outputs of two programs: bin-flip noise


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(jcls, tcls, kw, seed, gain=2.0):
    """(JAX model, its seeded variables, the port's model with them)."""
    jm = jcls(**kw)
    v = seeded_variables(jm, np.zeros((1, 6, 75, 216), np.float32), seed,
                         gain, train=False)
    tm = tcls(**kw).eval()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, tm


def _recording(t, seed):
    return np.random.RandomState(seed).rand(6, t, 216).astype(np.float32)


def test_shared_inc_matches_jax():
    """The port's shared forward against the JAX package's on the same
    weights and recording."""
    jm, v, tm = _pair(ju.SimpleUNetDoubleSelfAttn,
                      tmodels.SimpleUNetDoubleSelfAttn, TINY_ATTN, 0)
    inputs = _recording(20, 7)
    want = np.asarray(jshared.predict_framewise_shared(jm, v, inputs,
                                                       batch_size=10))
    got = predict_framewise_shared(tm, torch.from_numpy(inputs),
                                   batch_size=10)
    assert got.shape == want.shape == (20, 72)
    assert float(want.std()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("case", ["plain", "grouped", "residual", "unet"])
def test_shared_inc_matches_the_windowed_protocol(case):
    """Float-reassociation-close to ``predict_framewise``: the natural
    tail (23 frames: 10, 10, 3), grouped attention (28 frames at batch 10,
    group 5: 10, 10, 5, 3), ``residual`` down blocks (their shortcuts
    never touch ``inc``) and the Unet."""
    tcls, kw, group = {
        "plain": (tmodels.SimpleUNetDoubleSelfAttn, TINY_ATTN, None),
        "grouped": (tmodels.SimpleUNetDoubleSelfAttn,
                    dict(TINY_ATTN, attn_mode="cross_batch:5"), 5),
        "residual": (tmodels.SimpleUNetDoubleSelfAttn,
                     dict(TINY_ATTN, residual=True), None),
        "unet": (tmodels.SimpleUNetLargeKernels, TINY, None),
    }[case]
    tm = tcls(**kw).eval()
    tmodels.init_parameters(tm, torch.Generator().manual_seed(3))
    inputs = torch.from_numpy(_recording(28 if group else 23, 8))
    want = predict_framewise(tm, inputs, batch_size=10, group=group)
    got = predict_framewise_shared(tm, inputs, batch_size=10, group=group)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PROTOCOL_TOL,
                               rtol=0)


def test_shared_inc_assembles_each_windows_inc_output():
    """The assembled map is ``inc`` of each window: edges recomputed with
    the window's own padding, the interior from the dense pass."""
    tm = tmodels.SimpleUNetPolyphonyClassifSoftmax(**TINY).eval()
    tmodels.init_parameters(tm, torch.Generator().manual_seed(4))
    x = torch.log1p(10 * torch.from_numpy(_recording(30, 9)))
    xp = torch.nn.functional.pad(x, (0, 0, 37, 38))
    fwd = SharedIncForward(tm)
    ln, inc = fwd.precompute(xp)
    assert ln.shape == (1, 6, 105, 216) and inc.shape == (1, 4, 105, 216)
    centers = 37 + np.array([0, 1, 14, 29])
    windows = xp[:, torch.as_tensor(centers)[:, None]
                 + torch.arange(-37, 38)].transpose(0, 1)
    with torch.no_grad():
        want = tm.inc(tm.layernorm(windows))
    got = fwd.assemble(ln, inc, centers)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_shared_inc_punet_return_aux():
    """The PUnet's polyphony logits come through the shared forward."""
    tm = tmodels.SimpleUNetPolyphonyClassifSoftmax(
        **TINY, num_polyphony_steps=24).eval()
    tmodels.init_parameters(tm, torch.Generator().manual_seed(5))
    inputs = torch.from_numpy(_recording(13, 8))
    want, want_aux = predict_framewise(tm, inputs, batch_size=8,
                                       return_aux=True)
    got, aux = predict_framewise_shared(tm, inputs, batch_size=8,
                                        return_aux=True)
    assert aux.shape == want_aux.shape == (13, 24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PROTOCOL_TOL,
                               rtol=0)
    np.testing.assert_allclose(aux.numpy(), want_aux.numpy(),
                               atol=PROTOCOL_TOL, rtol=0)
    only = predict_framewise_shared(tm, inputs, batch_size=8)
    np.testing.assert_array_equal(only.numpy(), got.numpy())


def test_shared_inc_rejects_what_changes_inc():
    """``alt_order`` and a residual ``inc`` change ``inc``; the CNN family
    has none; the grouped batch must hold whole groups."""
    tm = tmodels.SimpleUNetLargeKernels(**TINY).eval()
    tm.alt_order = True
    with pytest.raises(ValueError, match="alt_order"):
        SharedIncForward(tm)
    tm = tmodels.SimpleUNetLargeKernels(**TINY).eval()
    tm.inc.resize = torch.nn.Conv2d(6, 4, (1, 1))
    with pytest.raises(ValueError, match="inc_residual"):
        SharedIncForward(tm)
    with pytest.raises(ValueError, match="inc"):
        SharedIncForward(tmodels.BasicCnnSegmSigmoid(
            n_chan_layers=(8, 8, 4, 2), n_bins_out=72).eval())
    with pytest.raises(ValueError, match="multiple"):
        predict_framewise_shared(tmodels.SimpleUNetLargeKernels(**TINY)
                                 .eval(), torch.zeros(6, 10, 216),
                                 batch_size=10, group=3)


def test_shared_inc_refuses_alt_order_and_freq_unets_as_jax_does():
    """A SAUnet built with ``alt_order=True`` is refused with the JAX
    package's error, word for word; a freq U-Net, which has no ``inc``,
    is refused by both (the JAX package at its first dense pass, with a
    ``KeyError``; the port when the forward is built)."""
    kw = dict(TINY_ATTN, alt_order=True)
    with pytest.raises(ValueError) as theirs:
        jshared.SharedIncForward(ju.SimpleUNetDoubleSelfAttn(**kw))
    with pytest.raises(ValueError) as ours:
        SharedIncForward(tmodels.SimpleUNetDoubleSelfAttn(**kw).eval())
    assert str(ours.value) == str(theirs.value)
    assert "alt_order" in str(ours.value)

    fkw = dict(n_chan_layers=(32, 8, 4, 2), n_bins_out=72, scalefac=2,
               embed_dim=32, num_heads=8, mlp_dim=64)
    jm, v, tm = _pair(ju.FreqUNetSelfAttn, tmodels.FreqUNetSelfAttn, fkw, 0)
    xp = jnp.zeros((6, 80, 216))
    with pytest.raises(KeyError, match="inc"):
        jshared.SharedIncForward(jm).precompute(v, xp)
    with pytest.raises(ValueError, match="FreqUNetSelfAttn has none"):
        SharedIncForward(tm)


def test_shared_inc_int8_matches_jax():
    """int8 downstream against the JAX package's
    ``predict_framewise_shared(int8=True)`` with the same static scales
    (the JAX package's, keyed by module path, carried across by
    ``torch_module_name``). The threshold quantizes three convs: XLA:CPU
    compiles each quantized conv slowly."""
    kw = dict(min_kernel_elems=16384)
    jm, v, tm = _pair(ju.SimpleUNetLargeKernels,
                      tmodels.SimpleUNetLargeKernels, TINY, 6)
    inputs = _recording(10, 11)
    cal = [jnp.log1p(10.0 * jnp.asarray(np.random.RandomState(12).rand(
        10, 6, 75, 216).astype(np.float32)))]
    jscales = jquant.calibrate_activation_scales(jm, v, cal, **kw)
    assert len(jscales) == 3
    want = np.asarray(jshared.predict_framewise_shared(
        jm, v, inputs, batch_size=10, activation_scales=jscales, int8=True,
        **kw))
    scales = {torch_module_name(k): torch.tensor(s, dtype=torch.float32)
              for k, s in jscales.items()}
    got = predict_framewise_shared(tm, torch.from_numpy(inputs),
                                   batch_size=10, activation_scales=scales,
                                   **kw)
    f32 = predict_framewise_shared(tm, torch.from_numpy(inputs),
                                   batch_size=10)
    assert float((got - f32).abs().max()) > 0            # int8 ran
    np.testing.assert_allclose(got.numpy(), want, atol=CROSS_PROGRAM, rtol=0)


def test_shared_inc_int8_keeps_inc_float32():
    """``inc``'s convs are eligible in the windowed int8 mode, and stay
    float32 in the shared one: the rest quantizes every other eligible
    conv."""
    tm = tmodels.SimpleUNetLargeKernels(**TINY).eval()
    eligible = {n for n, _ in eligible_convs(tm, 1024)}
    assert "inc.double_conv.0" in eligible
    fwd = SharedIncForward(tm, min_kernel_elems=1024, int8=True)
    quantized = {n for n, m in fwd.rest.named_modules()
                 if isinstance(m, Int8Conv2d)}
    assert quantized == {n for n in eligible if not n.startswith("inc.")}
