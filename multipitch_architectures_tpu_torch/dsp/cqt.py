"""Constant-Q transform.

Counterpart of ``multipitch_architectures_tpu/dsp/cqt.py``, the same
multirate scheme (Schörkhuber & Klapuri, as librosa.cqt):

- complex constant-Q kernels are built for the TOP octave only;
- octaves run top-down; between them a half-band FIR and 2:1 decimation
  halve the sample rate and the hop, so the same kernels serve again;
- each octave is framed (centered, reflect-padded) and multiplied by the
  kernel bank ``[Re K | -Im K]``; the magnitude is scaled so that a unit
  sinusoid at bin k peaks near sqrt(l_k)/2, ``l_k`` the full-rate filter
  length (librosa's ``scale=True``).

The plan (kernels, taps, geometry) is host-side numpy. A CQT first
builds its octaves' signals (the decimation chain and each reflect pad),
then hands the whole work list to one
:func:`..ops.cqt_octave.cqt_octaves` call: framing, product, magnitude
and scale of every octave, in one launch of the CUDA kernel for a signal
on the card. :func:`cqt_streamed` bounds the memory of a long recording
by running it in chunks of frames, one work list per chunk
(:func:`cqt_chunks`).
:func:`cqt_direct_numpy` is the float64 oracle, the constant-Q
definition evaluated directly.
"""

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.cqt_octave import Octave, bank_for_kernel, cqt_octaves


def _hann_periodic(n: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, as librosa's filter builder uses."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def cqt_q(bins_per_octave: int, filter_scale: float = 1.0) -> float:
    return filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)


def _top_octave_kernels(fs: float, fmax_octave_low: float,
                        bins_per_octave: int, filter_scale: float):
    """Complex kernels for one octave [f_low, 2·f_low), centered in a
    common power-of-two window. Returns (kernels (n_fft, bpo) complex128,
    lengths (bpo,), n_fft)."""
    q = cqt_q(bins_per_octave, filter_scale)
    freqs = fmax_octave_low * 2.0 ** (np.arange(bins_per_octave)
                                      / bins_per_octave)
    lengths = q * fs / freqs
    n_fft = int(2 ** math.ceil(math.log2(lengths.max())))
    kernels = np.zeros((n_fft, bins_per_octave), dtype=np.complex128)
    for k, (f, l) in enumerate(zip(freqs, lengths)):
        ilen = int(np.ceil(l))
        win = _hann_periodic(ilen)
        t = np.arange(-(ilen // 2), ilen - ilen // 2)
        phi = win * np.exp(2j * np.pi * f * t / fs)
        phi /= np.sum(np.abs(phi))        # L1 norm (librosa norm=1)
        start = n_fft // 2 - ilen // 2
        kernels[start:start + ilen, k] = phi
    return kernels, lengths, n_fft


@lru_cache(maxsize=None)
def _halfband_taps(num_taps: int = 127, beta: float = 8.0) -> np.ndarray:
    """Linear-phase half-band low-pass (cutoff 0.25·fs) for 2:1 decimation."""
    from scipy.signal import firwin

    return firwin(num_taps, 0.5, window=("kaiser", beta)).astype(np.float64)


def _bank(kernels: np.ndarray) -> np.ndarray:
    """(n_fft, bpo) complex kernels -> (n_fft, 2·bpo) float32 [Re | -Im]
    (the conjugate correlation as one real product)."""
    return np.concatenate([kernels.real, -kernels.imag],
                          axis=1).astype(np.float32)


@dataclass(frozen=True, eq=False)
class CqtPlan:
    """CQT geometry with its kernel banks.

    Multirate plans hold one bank (the top octave's) and the half-band
    taps; exact plans hold one full-rate bank per octave, lowest first,
    and no taps.
    """

    fs: float
    hop: int
    fmin: float
    n_bins: int
    bins_per_octave: int
    filter_scale: float
    exact: bool
    n_octaves: int
    krs: Tuple[np.ndarray, ...]
    sqrt_lengths: Tuple[np.ndarray, ...]
    n_ffts: Tuple[int, ...]
    taps: Optional[np.ndarray]
    _on_device: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def create(fs, hop, fmin, n_bins, bins_per_octave, filter_scale=1.0,
               exact=False):
        """``exact=True`` builds per-octave full-rate kernel banks and
        skips the decimation chain: the result matches the direct
        constant-Q definition to float32 rounding instead of the
        multirate scheme's kernel-reuse error, at the cost of full-rate
        framing in every octave."""
        n_octaves = int(math.ceil(n_bins / bins_per_octave))
        if hop % (2 ** (n_octaves - 1)) != 0:
            raise ValueError(
                f"hop ({hop}) must be divisible by 2^(n_octaves-1) "
                f"(= {2 ** (n_octaves - 1)})")
        f_low_top = fmin * 2.0 ** (n_octaves - 1)
        if f_low_top * 2.0 > fs / 2.0 * 1.01:
            raise ValueError("top octave exceeds Nyquist")
        if exact:
            octaves = [_top_octave_kernels(fs, fmin * 2.0 ** j,
                                           bins_per_octave, filter_scale)
                       for j in range(n_octaves)]
            taps = None
        else:
            octaves = [_top_octave_kernels(fs, f_low_top, bins_per_octave,
                                           filter_scale)]
            taps = _halfband_taps().astype(np.float32)
        return CqtPlan(
            fs, hop, fmin, n_bins, bins_per_octave, filter_scale, exact,
            n_octaves,
            krs=tuple(_bank(k) for k, _, _ in octaves),
            sqrt_lengths=tuple(np.sqrt(l).astype(np.float32)
                               for _, l, _ in octaves),
            n_ffts=tuple(n for _, _, n in octaves),
            taps=taps)

    def tensors(self, device):
        """(krs, banks, scales, taps) as tensors on ``device``, copied there
        once per plan and device. ``banks`` are the krs in the kernel's
        layout (:func:`bank_for_kernel`), on the card only (Nones
        elsewhere); ``scales`` hold each octave's magnitude scale: the
        full-rate ``sqrt(lengths)``, times ``sqrt(2^k)`` for octave k of a
        multirate plan."""
        key = torch.device(device)
        if key not in self._on_device:
            def on(a):
                return torch.as_tensor(a, device=key)

            sqls = [torch.as_tensor(s) for s in self.sqrt_lengths]
            if self.exact:
                scales = sqls
            else:
                # float32 products, as torch forms them on any device
                scales = [sqls[0] * np.sqrt(2.0 ** k)
                          for k in range(self.n_octaves)]
            banks = (None,) * len(self.krs)
            if key.type == "cuda":
                banks = tuple(on(bank_for_kernel(kr)) for kr in self.krs)
            self._on_device[key] = (
                tuple(map(on, self.krs)), banks,
                tuple(s.to(key) for s in scales),
                None if self.taps is None else on(self.taps))
        return self._on_device[key]


def _reflect_pad(y, pad):
    """Symmetric reflect pad of a 1-D tensor that tolerates pad >= len(y)
    by reflecting again, as ``jnp.pad(mode='reflect')`` applied
    repeatedly; ``F.pad(mode='reflect')`` alone raises there."""
    while pad > 0:
        p = min(pad, y.shape[0] - 1)
        y = F.pad(y.view(1, 1, -1), (p, p), mode="reflect").view(-1)
        pad -= p
    return y


def _decimate2(y, taps):
    """Half-band filter + 2:1 decimation (linear phase, 'same' alignment)
    as one strided conv1d. The taps are reversed as in the JAX package;
    they are symmetric, so correlation and convolution agree."""
    yp = _reflect_pad(y, taps.shape[0] // 2)
    out = F.conv1d(yp.view(1, 1, -1), taps.flip(0).view(1, 1, -1), stride=2)
    return out.view(-1)[:(y.shape[0] + 1) // 2]


def cqt(y, plan: CqtPlan):
    """Magnitude CQT of ``y`` (1-D float32 tensor) -> (n_bins, n_frames)
    float32 on ``y``'s device, ``n_frames = len(y) // hop + 1`` (librosa's
    centered convention)."""
    octaves, out = cqt_work_list(y, plan)
    cqt_octaves(octaves, bpo=plan.bins_per_octave)
    return out[:, -plan.n_bins:].T                # (n_bins, T)


def cqt_work_list(y, plan: CqtPlan):
    """The octaves of ``cqt(y, plan)`` as a work list for
    :func:`cqt_octaves`, and the (T, n_octaves·bpo) output they fill;
    ``out[:, -n_bins:].T`` is the CQT once they have run."""
    if y.dim() != 1 or y.dtype != torch.float32:
        raise ValueError(f"want a 1-D float32 signal, got {y.dtype} "
                         f"{tuple(y.shape)}")
    krs, banks, scales, taps = plan.tensors(y.device)
    if plan.exact:
        return _cqt_exact_impl(y, krs, banks, scales, hop=plan.hop,
                               n_ffts=plan.n_ffts,
                               bpo=plan.bins_per_octave)
    return _cqt_impl(y, krs[0], banks[0], scales, taps, hop=plan.hop,
                     n_fft=plan.n_ffts[0], n_octaves=plan.n_octaves,
                     bpo=plan.bins_per_octave)


def _output(y, hop, n_octaves, bpo):
    return torch.empty((y.shape[0] // hop + 1, n_octaves * bpo),
                       dtype=torch.float32, device=y.device)


def _cqt_exact_impl(y, krs, banks, scales, *, hop, n_ffts, bpo):
    """Exact CQT: per-octave full-rate banks, no decimation. Octave j is
    bins [j·bpo, (j+1)·bpo) from fmin, columns [j·bpo, (j+1)·bpo)."""
    out = _output(y, hop, len(krs), bpo)
    octaves = [Octave(_reflect_pad(y, n_fft // 2), kr, bank, scale, out,
                      hop=hop, n_fft=n_fft, n_frames=out.shape[0],
                      col=j * bpo)
               for j, (kr, bank, scale, n_fft) in enumerate(
                   zip(krs, banks, scales, n_ffts))]
    return octaves, out


def _cqt_impl(y, kr, bank, scales, taps, *, hop, n_fft, n_octaves, bpo):
    """Multirate CQT: octave k, from the top, is the signal decimated k
    times with the hop halved k times, and covers bins
    [n_bins - (k+1)·bpo, n_bins - k·bpo), columns
    [(n_octaves-1-k)·bpo, (n_octaves-k)·bpo)."""
    out = _output(y, hop, n_octaves, bpo)
    octaves = []
    for k in range(n_octaves):
        octaves.append(Octave(_reflect_pad(y, n_fft // 2), kr, bank,
                              scales[k], out, hop=hop, n_fft=n_fft,
                              n_frames=out.shape[0],
                              col=(n_octaves - 1 - k) * bpo))
        if k + 1 < n_octaves:
            y = _decimate2(y, taps)
            hop //= 2
    return octaves, out


def cqt_context(plan: CqtPlan) -> int:
    """Samples of real signal that a chunk of :func:`cqt_streamed` needs on
    each side of its frames for them to equal the whole recording's:
    the lowest octave's kernel half-support, for a multirate plan at the
    deepest rate plus the decimation chain's reach, rounded up to a whole
    hop so that chunk starts stay on the frame and decimation grid
    (``hop % 2^(n_octaves-1) == 0``)."""
    if plan.exact:
        ctx = plan.n_ffts[0] // 2
    else:
        deep = 2 ** (plan.n_octaves - 1)
        ctx = (plan.n_ffts[0] // 2) * deep + (len(plan.taps) // 2) * 2 * deep
    return -(-ctx // plan.hop) * plan.hop


def cqt_chunks(y, plans, chunk_frames: int):
    """The CQTs of ``plans`` (one hop, one bins-per-octave) of the 1-D
    float32 tensor ``y``, in chunks of ``chunk_frames`` frames: yields
    ``(c0, c1, [each plan's frames c0..c1 as a (c1 - c0, n_bins) tensor
    on y's device])``, the CQTs' transposes, which the next chunk
    overwrites.

    Each chunk carries the largest of the plans' :func:`cqt_context` of
    real samples on both sides, so its frames equal the whole
    recording's (up to the float32 rounding of the decimating convolution
    over another length); the first and last chunks end at the
    recording's own edges, which keep their reflect padding. All plans'
    octaves of a chunk form one work list: one launch of the kernel per
    chunk for up to ``MAX_ENTRIES`` octaves.
    """
    hop = plans[0].hop
    bpo = plans[0].bins_per_octave
    if any(p.hop != hop or p.bins_per_octave != bpo for p in plans):
        raise ValueError("streamed plans must share hop and bins per octave")
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be positive, got {chunk_frames}")
    n = y.shape[0]
    n_frames = n // hop + 1
    ctx = max(cqt_context(p) for p in plans)
    for c0 in range(0, n_frames, chunk_frames):
        c1 = min(n_frames, c0 + chunk_frames)
        s0 = max(0, c0 * hop - ctx)
        s1 = min(n, (c1 - 1) * hop + ctx)
        work, outs = [], []
        for p in plans:
            octaves, out = cqt_work_list(y[s0:s1], p)
            work += octaves
            outs.append(out)
        cqt_octaves(work, bpo=bpo)
        local0 = c0 - s0 // hop
        yield c0, c1, [out[local0:local0 + c1 - c0, -p.n_bins:]
                       for p, out in zip(plans, outs)]


def cqt_streamed(y, plan: CqtPlan, chunk_frames: int = 8192,
                 device=None) -> np.ndarray:
    """Bounded-memory CQT of a long recording: (n_bins, n_frames) float32
    host numpy, equal to ``cqt(y, plan)`` up to float32 rounding (see
    :func:`cqt_chunks`). A tensor ``y`` runs where it lies; an array goes
    to ``device``, by default the card (and raises without one unless
    given ``device="cpu"``)."""
    y = as_signal(y, device)
    out = np.empty((plan.n_bins, y.shape[0] // plan.hop + 1), np.float32)
    for c0, c1, (mag,) in cqt_chunks(y, [plan], chunk_frames):
        out[:, c0:c1] = mag.T.cpu().numpy()
    return out


def as_signal(y, device=None) -> torch.Tensor:
    """``y`` as a 1-D float32 tensor: a tensor stays where it lies (unless
    ``device`` is given), an array goes to ``resolve_device(device)``."""
    if isinstance(y, torch.Tensor) and device is None:
        return y.to(torch.float32)
    return torch.as_tensor(y, dtype=torch.float32,
                           device=resolve_device(device))


def cqt_direct_numpy(y, fs, hop, fmin, n_bins, bins_per_octave,
                     filter_scale=1.0):
    """Slow exact reference: direct time-domain correlation with full-rate
    constant-Q kernels at every bin (the mathematical definition; float64).
    Used by tests as the oracle for the fast multirate implementation."""
    q = cqt_q(bins_per_octave, filter_scale)
    y = np.asarray(y, np.float64)
    n_frames = len(y) // hop + 1
    out = np.zeros((n_bins, n_frames))
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    lengths = q * fs / freqs
    max_len = int(np.ceil(lengths.max()))
    pad = max_len // 2 + 1
    yp = np.pad(y, (pad, pad), mode="reflect")
    for k, (f, l) in enumerate(zip(freqs, lengths)):
        ilen = int(np.ceil(l))
        win = _hann_periodic(ilen)
        t = np.arange(-(ilen // 2), ilen - ilen // 2)
        phi = win * np.exp(2j * np.pi * f * t / fs)
        phi /= np.sum(np.abs(phi))
        for tt in range(n_frames):
            center = tt * hop + pad
            seg = yp[center - ilen // 2: center - ilen // 2 + ilen]
            out[k, tt] = np.abs(np.vdot(phi, seg)) * np.sqrt(l)
    return out
