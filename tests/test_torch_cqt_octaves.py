"""The CQT octave kernel's work list, its plain version and its bank layout,
on the CPU.

The kernel itself (``csrc/cqt_octave.cu``, split-TF32 wgmma) runs only on
a CUDA card, where chip_smoke.py holds it against its plain version. Here
the plain version of a whole work list is held against the JAX package's
Pallas kernel in interpret mode, entry by entry; the bank layout that the
kernel's wgmma descriptors read is checked element by element; and a
numpy emulation of the split-TF32 product pins down the accuracy that the
kernel relies on.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.ops.pallas_cqt import cqt_octave_pallas
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.dsp import hcqt
from multipitch_architectures_tpu_torch.ops.cqt_octave import (
    KC, Octave, bank_for_kernel, cqt_octaves,
    cqt_octaves_launcher, cqt_octaves_reference, kernel_width, launch_plan,
    tf32_round)
from multipitch_architectures_tpu_torch.utils import counters

tcqt = sys.modules["multipitch_architectures_tpu_torch.dsp.cqt"]
tharm = sys.modules["multipitch_architectures_tpu_torch.dsp.hcqt"]

FS = 22050
BENCH_HCQT = dict(fs_hcqt_target=50, bins_per_octave=36, num_octaves=6,
                  tuning=0.0)

# (n_fft, hop, n_frames) of each work list's entries, by bins per octave
ENTRIES = {36: [(512, 512, 431), (256, 64, 301), (512, 2, 37)],
           12: [(256, 512, 37), (512, 64, 301), (256, 8, 431)]}


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bank_from_kernel(bank, bpo):
    """(hi, lo) as (n_fft, 2·bpo) ``[Re | -Im]`` arrays: the inverse of
    bank_for_kernel's layout."""
    chunks, _, planes, n, _ = bank.shape
    parts = bank.transpose(1, 0, 2, 4, 3).reshape(2, chunks * planes * 4, n)
    return tuple(np.concatenate([p[:, 0:2 * bpo:2], p[:, 1:2 * bpo:2]],
                                axis=1) for p in parts)


def _rel_to_peak(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _work_list(bpo):
    """One work list of bpo bins: random signals, banks and scales, each
    entry in its own columns of one shared output, the last entry's first.
    Returns (octaves, their numpy inputs)."""
    rng = np.random.RandomState(bpo)
    entries = ENTRIES[bpo]
    out = torch.full((max(t for _, _, t in entries), len(entries) * bpo),
                     float("nan"))
    octaves, inputs = [], []
    for i, (n_fft, hop, t) in enumerate(entries):
        y = rng.rand((t - 1) * hop + n_fft).astype(np.float32)
        kr = (rng.randn(n_fft, 2 * bpo) * 0.01).astype(np.float32)
        scale = rng.uniform(1, 40, bpo).astype(np.float32)
        col = (len(entries) - 1 - i) * bpo
        octaves.append(Octave(torch.from_numpy(y), torch.from_numpy(kr),
                              None, torch.from_numpy(scale), out, hop=hop,
                              n_fft=n_fft, n_frames=t, col=col))
        inputs.append((y, kr, scale))
    return octaves, inputs


_LISTS = {}


def _filled(bpo):
    """The work list of bpo bins after one cqt_octaves call (on the CPU:
    the plain version), made once per module."""
    if bpo not in _LISTS:
        octaves, inputs = _work_list(bpo)
        before = counters["k1.launches"]
        cqt_octaves(octaves, bpo=bpo)
        assert counters["k1.launches"] == before     # CPU tensors: plain
        _LISTS[bpo] = octaves, inputs
    return _LISTS[bpo]


@pytest.mark.parametrize("bpo,i", [(b, i) for b in ENTRIES
                                   for i in range(len(ENTRIES[b]))])
def test_work_list_matches_pallas_kernel(bpo, i):
    """Entry i's columns of the shared output: the JAX package's Pallas
    kernel (interpret mode) times the entry's scale, rel-to-peak 1e-5
    (float32 sums of n_fft products in another order)."""
    octaves, inputs = _filled(bpo)
    o, (y, kr, scale) = octaves[i], inputs[i]
    want = np.asarray(cqt_octave_pallas(
        jnp.asarray(y), jnp.asarray(kr), hop=o.hop, n_fft=o.n_fft, bpo=bpo,
        n_frames=o.n_frames, interpret=True)) * scale
    got = o.out[:o.n_frames, o.col:o.col + bpo].numpy()
    assert got.shape == want.shape == (o.n_frames, bpo)
    assert _rel_to_peak(got, want) < 1e-5
    # rows past the entry's frames stay untouched
    assert torch.isnan(o.out[o.n_frames:, o.col:o.col + bpo]).all()


@pytest.mark.parametrize("bpo", [36, 12, 60, 64])
def test_bank_hi_lo_split(bpo):
    """hi is a TF32 value (its low 13 bits are 0), and so is lo; hi + lo
    gives back kr to within 2^-21 of its magnitude (22 of float32's 24
    bits); the padding columns are 0."""
    rng = np.random.RandomState(bpo)
    kr = (rng.randn(256, 2 * bpo) * 10.0 ** rng.uniform(-6, 1, 2 * bpo)
          ).astype(np.float32)
    bank = bank_for_kernel(kr)
    n = kernel_width(bpo)
    assert bank.shape == (256 // KC, 2, KC // 4, n, 4)
    assert bank.dtype == np.float32
    assert not (bank.view(np.uint32) & np.uint32(0x1FFF)).any()
    hi, lo = bank_from_kernel(bank, bpo)
    np.testing.assert_array_equal(hi, tf32_round(kr))
    assert (np.abs(hi.astype(np.float64) + lo - kr)
            <= 2.0 ** -21 * np.abs(kr)).all()
    assert not bank[:, :, :, 2 * bpo:, :].any()


def test_bank_layout_is_what_the_descriptors_read():
    """Undoing the interleave and the K-chunk order gives back kr exactly
    (for values that TF32 holds exactly, lo is 0), and element (sample k,
    column c) of the interleaved bank sits where the kernel's wgmma
    descriptor reads it: in chunk k // KC, hi then lo, 4-sample planes of
    N 16-byte rows (leading byte offset 16·N between planes), 8-row core
    matrices 128 bytes apart (stride byte offset)."""
    bpo, n_fft = 12, 64          # 1536 distinct integers: TF32 holds 2048
    kr = np.arange(n_fft * 2 * bpo, dtype=np.float32).reshape(n_fft, -1)
    bank = bank_for_kernel(kr)
    hi, lo = bank_from_kernel(bank, bpo)
    np.testing.assert_array_equal(hi, kr)
    assert not lo.any()
    n = kernel_width(bpo)
    flat = bank.reshape(-1)
    for k in range(n_fft):
        for c in range(2 * bpo):
            chunk, kk = divmod(k, KC)
            byte = (chunk * 2 * KC * n * 4            # chunk, hi part
                    + (kk // 4) * 16 * n              # plane: LBO
                    + (c // 8) * 128 + (c % 8) * 16   # core matrix: SBO
                    + (kk % 4) * 4)
            b, part = divmod(c, 2)                    # re, im of bin b
            assert flat[byte // 4] == kr[k, b + part * bpo]


def test_split_tf32_product_keeps_float32_accuracy():
    """A numpy emulation of the kernel's product at one serving octave
    (the top octave of the bench HCQT's base, hop 512, 36 bins, a
    harmonic tone): A split into TF32 hi and lo as cvt.rna does, the bank
    as bank_for_kernel splits it, lo·hi + hi·lo + hi·hi summed exactly
    per K chunk and rounded to float32 there, the chunks summed in
    float32. Within 2e-6 rel-to-peak of float64; plain TF32 (hi·hi) is
    not within 1e-4."""
    bpo = 36
    kernels, _, n_fft = tcqt._top_octave_kernels(FS, 32.703 * 2 ** 5, bpo,
                                                  1.0)
    kr = tcqt._bank(kernels)
    t = np.arange(int(2.0 * FS)) / FS
    y = sum((1.0 / h) * np.sin(2 * np.pi * 261.63 * h * t)
            for h in (1, 2, 3, 4, 5)).astype(np.float32)
    y = np.pad(y, n_fft // 2, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(y, n_fft)[::512]
    a_hi = tf32_round(frames)
    a_lo = tf32_round(frames - a_hi)
    b_hi, b_lo = bank_from_kernel(bank_for_kernel(kr), bpo)

    def magnitudes(ri):
        re, im = ri[:, :bpo], ri[:, bpo:]
        return np.sqrt(re * re + im * im + np.float32(1e-30))

    total = np.zeros((frames.shape[0], 2 * bpo), dtype=np.float32)
    plain = np.zeros_like(total)
    f64 = [np.float64]
    for k0 in range(0, n_fft, KC):
        k = np.s_[:, k0:k0 + KC]
        ah, al = (x[k].astype(*f64) for x in (a_hi, a_lo))
        bh, bl = (x[k0:k0 + KC].astype(*f64) for x in (b_hi, b_lo))
        total += (al @ bh + ah @ bl + ah @ bh).astype(np.float32)
        plain += (ah @ bh).astype(np.float32)
    want = magnitudes(frames.astype(np.float64) @ kr.astype(np.float64))
    assert _rel_to_peak(magnitudes(total), want) < 2e-6
    assert _rel_to_peak(magnitudes(plain), want) > 1e-4


@pytest.mark.parametrize("seconds,frames", [(117.701, 5069), (10.0, 431)])
def test_bench_hcqt_work_list(monkeypatch, seconds, frames):
    """The serving HCQT hands one work list to the kernel: 21 octaves
    (bases 0.5, 3 and 5: 9, 6 and 6), hops halving from 512, columns
    from the top octave down in each base's output, and the blocks that
    the launch walks, counted by hand. On the meta device: only shapes."""
    calls = []
    monkeypatch.setattr(tharm, "cqt_octaves",
                        lambda octaves, bpo: calls.append((octaves, bpo)))
    y = torch.empty(int(seconds * FS), device="meta")
    hcqt(y, **BENCH_HCQT)
    assert len(calls) == 1
    octaves, bpo = calls[0]
    assert bpo == 36 and len(octaves) == 21
    bases = [(9, 512), (6, 512), (6, 256)]
    want = [(n_fft, 512 >> k, (n - 1 - k) * 36, n * 36)
            for n, n_fft in bases for k in range(n)]
    assert [(o.n_fft, o.hop, o.col, o.out.shape[1]) for o in octaves] == want
    assert all(o.n_frames == frames and o.out.shape[0] == frames
               for o in octaves)
    assert len({id(o.out) for o in octaves}) == 3
    assert all(o.y.shape[0] >= (frames - 1) * o.hop + o.n_fft
               for o in octaves)
    order, starts = launch_plan(octaves)
    assert order == list(range(21))       # n_fft 512 first, stable
    per = -(-frames // 64)                # 80 tiles of 64 frames, or 7
    assert starts == [per * i for i in range(22)]
    assert starts[-1] == {5069: 1680, 431: 147}[frames]


def test_launch_plan_orders_longest_first():
    out = torch.empty(100, 36)
    kw = dict(kr=None, bank=None, scale=None, out=out, hop=64, col=0)
    octaves = [Octave(None, n_fft=n, n_frames=t, **kw)
               for n, t in ((256, 100), (1024, 65), (512, 1))]
    assert launch_plan(octaves) == ([1, 2, 0], [0, 2, 3, 5])
    assert launch_plan(octaves, 128) == ([1, 2, 0], [0, 1, 2, 3])


def test_cqt_octaves_checks_its_inputs():
    octaves, _ = _work_list(12)
    with pytest.raises(ValueError, match="kr"):
        cqt_octaves(octaves, bpo=36)
    with pytest.raises(ValueError, match="no CQT octave kernel"):
        cqt_octaves_launcher(octaves, bpo=12)
    o = octaves[0]
    short = Octave(o.y[:100], o.kr, None, o.scale, o.out, hop=o.hop,
                   n_fft=o.n_fft, n_frames=o.n_frames, col=o.col)
    with pytest.raises(ValueError, match="need"):
        cqt_octaves([short], bpo=12)
    wide = Octave(o.y, o.kr, None, o.scale, o.out, hop=o.hop, n_fft=o.n_fft,
                  n_frames=o.n_frames, col=o.out.shape[1] - 6)
    with pytest.raises(ValueError, match="do not fit"):
        cqt_octaves([wide], bpo=12)
    with pytest.raises(ValueError, match="empty"):
        cqt_octaves([], bpo=12)


@pytest.mark.parametrize("bpo,width", [(12, 24), (24, 48), (36, 72),
                                       (48, 96), (60, 120), (64, 128),
                                       (4, 24), (40, 96)])
def test_kernel_width(bpo, width):
    assert kernel_width(bpo) == width


@pytest.mark.parametrize("bpo", [0, 6, 65, 66])
def test_kernel_width_refuses(bpo):
    with pytest.raises(ValueError, match="bpo"):
        kernel_width(bpo)


def test_cqt_octaves_reference_scales_and_places():
    """The plain version is cqt_octave_reference times the scale, in the
    entry's columns, bit for bit."""
    from multipitch_architectures_tpu_torch.ops.cqt_octave import (
        cqt_octave_reference)

    octaves, _ = _work_list(36)
    cqt_octaves_reference(octaves, bpo=36)
    for o in octaves:
        want = cqt_octave_reference(o.y, o.kr, hop=o.hop, n_fft=o.n_fft,
                                    bpo=36, n_frames=o.n_frames) * o.scale
        torch.testing.assert_close(o.out[:o.n_frames, o.col:o.col + 36],
                                   want, rtol=0, atol=0)
