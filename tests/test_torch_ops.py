"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both packages as the same arrays.
The CQT octave kernel itself runs only on a CUDA card (chip_smoke.py
compares it with its plain version there); here the wrapper takes the
plain version, which is held against the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.ops import attention as jattn
from multipitch_architectures_tpu.ops.pallas_cqt import cqt_octave_pallas
from multipitch_architectures_tpu.ops.resize import up_concat_pad as j_ucp
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.ops import (TorchMultiheadAttention,
                                                    sinusoidal_positional_encoding,
                                                    up_concat_pad)
from multipitch_architectures_tpu_torch.ops.cqt_octave import (
    cqt_octave, cqt_octave_reference)
from multipitch_architectures_tpu_torch.utils import counters


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, and one torch thread: with several, torch's
    CPU sgemm (MKL, torch 2.13) gave a wrong first product for a new shape
    in about 1 of 60 fresh processes on an AMX-capable Xeon (error 8e-5
    where float32 gives 2e-7); with one thread it never did in 240."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("hop,n_fft,bpo,t", [
    (64, 512, 72, 300),      # the JAX package's own kernel test shapes
    (2, 256, 36, 301),       # the serving path's deepest base-5 octave
])
def test_cqt_octave_plain_matches_pallas_kernel(hop, n_fft, bpo, t):
    """atol 1e-5, as tests/test_ops.py holds the Pallas kernel: float32
    sums of n_fft products in another order."""
    rng = np.random.RandomState(0)
    y = rng.rand(t * hop + n_fft).astype(np.float32)
    kr = (rng.randn(n_fft, 2 * bpo) * 0.01).astype(np.float32)
    want = np.asarray(cqt_octave_pallas(
        jnp.asarray(y), jnp.asarray(kr), hop=hop, n_fft=n_fft, bpo=bpo,
        n_frames=t, interpret=True))
    before = counters["k1.launches"]
    got = cqt_octave(torch.from_numpy(y), torch.from_numpy(kr), hop=hop,
                     n_fft=n_fft, bpo=bpo, n_frames=t)
    assert got.shape == (t, bpo) and got.dtype == torch.float32
    assert counters["k1.launches"] == before     # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cqt_octave_checks_its_inputs():
    y, kr = torch.zeros(1000), torch.zeros(256, 72)
    kw = dict(hop=64, n_fft=256, bpo=36)
    with pytest.raises(ValueError, match="need"):
        # 13 frames need 12·64 + 256 = 1024 samples: every frame must lie
        # inside the signal, so no tail padding is chosen silently
        cqt_octave(y, kr, n_frames=13, **kw)
    with pytest.raises(ValueError, match="kr"):
        cqt_octave(y, torch.zeros(256, 70), n_frames=4, **kw)
    with pytest.raises(ValueError, match="no CQT octave kernel"):
        cqt_octave(y.to("meta"), kr.to("meta"), n_frames=4, **kw)
    assert cqt_octave(y, kr, n_frames=12, **kw).shape == (12, 36)


def test_cqt_octave_plain_zero_extends_like_the_kernel():
    rng = np.random.RandomState(1)
    y = torch.from_numpy(rng.rand(900).astype(np.float32))
    kr = torch.from_numpy(rng.randn(256, 8).astype(np.float32))
    kw = dict(hop=64, n_fft=256, bpo=4, n_frames=13)
    padded = torch.cat([y, torch.zeros(124)])
    torch.testing.assert_close(cqt_octave_reference(y, kr, **kw),
                               cqt_octave_reference(padded, kr, **kw),
                               rtol=0, atol=0)


def _jax_mha(mode, e, heads, x, seed=0):
    m = jattn.TorchMultiheadAttention(embed_dim=e, num_heads=heads, mode=mode)
    return m, m.init(jax.random.PRNGKey(seed), x, x, x)


def _torch_mha(variables, e, heads, mode):
    p = {k: torch.from_numpy(np.asarray(v))
         for k, v in variables["params"].items()}
    m = TorchMultiheadAttention(e, heads, mode=mode)
    m.load_state_dict({"in_proj_weight": p["in_proj_weight"],
                       "in_proj_bias": p["in_proj_bias"],
                       "out_proj.weight": p["out_proj_weight"],
                       "out_proj.bias": p["out_proj_bias"]})
    return m


@pytest.mark.parametrize("mode", ["cross_batch", "cross_batch:5", "tokens"])
def test_attention_modes_match_jax(mode):
    """atol 1e-5: float32 matmuls and softmax over 32-wide embeddings in
    another order."""
    e, heads, b, s = 32, 8, 10, 7
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(b, s, e).astype(np.float32) for _ in range(3))
    jm, variables = _jax_mha(mode, e, heads, jnp.asarray(q))
    # a nonzero in_proj bias, so its layout is checked too
    variables = {"params": {**variables["params"], "in_proj_bias":
                            rng.randn(3 * e).astype(np.float32)}}
    want = np.asarray(jm.apply(variables, jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v)))
    tm = _torch_mha(variables, e, heads, mode)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_grouped_attention_equals_separate_batches():
    """``cross_batch:<g>`` on a k·g batch gives k separate g-sized
    batches of plain ``cross_batch`` (atol 2e-6, as tests/test_ops.py);
    a batch smaller than g attends over itself; a batch that is no
    multiple of g raises."""
    e, s, g, k = 32, 7, 10, 3
    torch.manual_seed(0)
    plain = TorchMultiheadAttention(e, 4, mode="cross_batch")
    grouped = TorchMultiheadAttention(e, 4, mode=f"cross_batch:{g}")
    grouped.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).randn(k * g, s, e)
                         .astype(np.float32))
    with torch.no_grad():
        want = torch.cat([plain(c, c, c) for c in x.split(g)])
        torch.testing.assert_close(grouped(x, x, x), want, rtol=0, atol=2e-6)
        tail = x[:7]
        torch.testing.assert_close(grouped(tail, tail, tail),
                                   plain(tail, tail, tail), rtol=0, atol=2e-6)
        with pytest.raises(ValueError, match="multiple"):
            grouped(x[:15], x[:15], x[:15])
    with pytest.raises(ValueError, match="unknown attention mode"):
        TorchMultiheadAttention(e, 4, mode="heads")


def test_positional_encoding_matches_jax():
    np.testing.assert_array_equal(sinusoidal_positional_encoding(600, 256),
                                  jattn.sinusoidal_positional_encoding(600,
                                                                       256))


@pytest.mark.parametrize("h1,w1,h2,w2", [(4, 13, 9, 27), (37, 108, 75, 216)])
def test_up_concat_pad_matches_jax(h1, w1, h2, w2):
    """Odd skip sizes make the (left, right, top, bottom) pad order bite.
    atol 1e-6: both packages upsample with the same float64-built
    interpolation operators as two products (``F.interpolate``, the
    reference's op, samples at float32 positions: 2.7e-5 away at
    37x108 -> 75x216)."""
    rng = np.random.RandomState(3)
    x1 = rng.randn(2, 3, h1, w1).astype(np.float32)
    x2 = rng.randn(2, 5, h2, w2).astype(np.float32)
    want = np.asarray(j_ucp(jnp.asarray(x1.transpose(0, 2, 3, 1)),
                            jnp.asarray(x2.transpose(0, 2, 3, 1))))
    got = up_concat_pad(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == (2, 8, h2, w2)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-6)
