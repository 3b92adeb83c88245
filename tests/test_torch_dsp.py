"""The port's CQT and HCQT against the JAX package's and the committed
direct-DFT oracle, on the CPU (each octave through the kernel's plain
version). Audio comes from numpy and goes to both packages as the same
array."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multipitch_architectures_tpu.dsp  # noqa: F401
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.dsp import CqtPlan, cqt, hcqt

jcqt = sys.modules["multipitch_architectures_tpu.dsp.cqt"]
jhcqt = sys.modules["multipitch_architectures_tpu.dsp.hcqt"]
tcqt = sys.modules["multipitch_architectures_tpu_torch.dsp.cqt"]
tharm = sys.modules["multipitch_architectures_tpu_torch.dsp.hcqt"]

FS = 22050
BENCH_HCQT = dict(fs_hcqt_target=50, bins_per_octave=36, num_octaves=6,
                  tuning=0.0)


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_to_peak(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _tone(seconds, seed=0):
    t = np.arange(int(seconds * FS)) / FS
    y = sum((1.0 / h) * np.sin(2 * np.pi * 261.63 * h * t)
            for h in (1, 2, 3, 4, 5))
    return (y + 1e-3 * np.random.RandomState(seed).randn(len(t))).astype(
        np.float32)


@pytest.mark.parametrize("n,pad", [(5, 12), (300, 64), (2, 7)])
def test_reflect_pad_reflects_again_past_the_signal(n, pad):
    """``F.pad(mode='reflect')`` alone raises for pad >= len; the port
    reflects repeatedly, exactly like the JAX package."""
    y = np.random.RandomState(n).randn(n).astype(np.float32)
    got = tcqt._reflect_pad(torch.from_numpy(y), pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcqt._reflect_pad(
        jnp.asarray(y), pad)))


@pytest.mark.parametrize("n", [1001, 40000])
def test_decimate2_matches_jax(n):
    """One strided conv1d against the JAX package's single conv (short
    signals) and its rowed conv (signals over 16384 samples, a TPU compile
    workaround): identical up to float32 sums of 127 taps in another
    order, atol 1e-6."""
    y = np.random.RandomState(4).randn(n).astype(np.float32)
    taps = tcqt._halfband_taps().astype(np.float32)
    got = tcqt._decimate2(torch.from_numpy(y), torch.from_numpy(taps))
    want = np.asarray(jcqt._decimate2(jnp.asarray(y), jnp.asarray(taps)))
    assert got.shape == want.shape == ((n + 1) // 2,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
def test_cqt_matches_jax(exact):
    """2 s of audio, multirate and exact plans: rel-to-peak 1e-5, float32
    rounding of the same arithmetic (as tests/test_ops.py holds the Pallas
    path to the XLA path)."""
    y = _tone(2.0)
    kw = dict(fs=FS, hop=512, fmin=32.703, n_bins=216, bins_per_octave=36,
              exact=exact)
    got = cqt(torch.from_numpy(y), CqtPlan.create(**kw)).numpy()
    want = np.asarray(jcqt.cqt(y, jcqt.CqtPlan.create(**kw)))
    assert got.shape == want.shape == (216, len(y) // 512 + 1)
    assert _rel_to_peak(got, want) < 1e-5


def test_cqt_matches_committed_direct_oracle():
    """Against the float64 direct-DFT oracle (tests/goldens): the
    multirate plan within 1e-3 rel-to-peak on interior frames, its
    kernel-reuse approximation (tests/test_dsp.py:253), and the exact plan
    within 1e-4 on all frames (tests/test_dsp.py:276)."""
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "cqt_direct_oracle_4s.npz"))
    kw = dict(fs=int(g["fs"]), hop=int(g["hop"]), fmin=float(g["fmin"]),
              n_bins=int(g["n_bins"]),
              bins_per_octave=int(g["bins_per_octave"]))
    y = torch.from_numpy(g["audio"])
    oracle = g["oracle"]
    multirate = cqt(y, CqtPlan.create(**kw)).numpy()
    exact = cqt(y, CqtPlan.create(**kw, exact=True)).numpy()
    assert multirate.shape == exact.shape == oracle.shape
    interior = np.s_[:, 20:-20]
    assert _rel_to_peak(multirate[interior], oracle[interior]) < 1e-3
    assert _rel_to_peak(exact, oracle) < 1e-4


def test_hcqt_matches_jax_at_bench_settings():
    """The serving path's HCQT (hop 512, 36 bins per octave, 6 octaves,
    6 channels) on 3 s: rel-to-peak 1e-5, and the same layout and
    geometry as the JAX package."""
    y = _tone(3.0, seed=1)
    got, fs_got, hop_got = hcqt(y, **BENCH_HCQT)
    want, fs_want, hop_want = jhcqt.efficient_hcqt_device(y, **BENCH_HCQT)
    want = np.asarray(want)
    assert (fs_got, hop_got) == (fs_want, hop_want) == (FS / 512, 512)
    assert got.shape == want.shape == (6, len(y) // 512 + 1, 216)
    assert got.dtype == torch.float32
    assert _rel_to_peak(got.numpy(), want) < 1e-5


def test_harmonic_layout_matches_jax():
    for n_harm, n_sub in [(5, 1), (6, 2), (3, 0)]:
        assert (tharm._harmonic_layout(n_harm, n_sub)
                == jhcqt._harmonic_layout(n_harm, n_sub))
    # the serving HCQT: bases 0.5, 3, 5 with 9 + 6 + 6 = 21 octaves
    _, assignment = tharm._harmonic_layout(5, 1)
    assert assignment == [(0.5, 0), (0.5, 1), (0.5, 2), (3.0, 0), (0.5, 3),
                          (5.0, 0)]
