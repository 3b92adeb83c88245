"""Tuning estimation: the librosa ``estimate_tuning`` algorithm (STFT
peak-picking with parabolic interpolation and a deviation histogram).

Counterpart of ``multipitch_architectures_tpu/dsp/tuning.py``, the same
float64 numpy on the host, so that the estimate equals the JAX package's
bit for bit. The reference calls ``librosa.estimate_tuning(audio,
bins_per_octave=…)`` before building the (H)CQT and shifts fmin by the
estimated fraction of a bin (libdl/data_preprocessing/hcqt.py:122-123).
The STFT stays on the host and in float64: a float32 STFT can move the
histogram's argmax, and the tuning shifts every bin of the features.
"""

import numpy as np


def _stft_mag(y, n_fft=2048, hop=512):
    pad = n_fft // 2
    yp = np.pad(np.asarray(y, np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(yp) - n_fft) // hop
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = yp[idx] * win
    return np.abs(np.fft.rfft(frames, axis=1)).T  # (n_fft//2+1, n_frames)


def piptrack(y, fs=22050.0, n_fft=2048, hop=512, fmin=150.0, fmax=4000.0,
             threshold=0.1):
    """Parabolic-interpolation pitch tracking on STFT peaks.

    Returns (pitches, mags): arrays of interpolated peak frequencies (Hz)
    and their magnitudes, one entry per (peak bin, frame) above threshold.
    """
    s = _stft_mag(y, n_fft, hop)
    n_bins = s.shape[0]
    freqs_bin = np.arange(n_bins) * fs / n_fft

    # parabolic interpolation around each bin
    prev = np.vstack([s[:1], s[:-1]])
    nxt = np.vstack([s[1:], s[-1:]])
    denom = prev - 2 * s + nxt
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (prev - nxt) / denom, 0.0)

    # local maxima above per-frame threshold, inside [fmin, fmax]
    is_peak = (s > prev) & (s >= nxt)
    ref = threshold * s.max(axis=0, keepdims=True)
    mask = is_peak & (s > ref)
    mask &= (freqs_bin[:, None] >= fmin) & (freqs_bin[:, None] < fmax)

    bins = np.nonzero(mask)
    pitches = (bins[0] + shift[bins]) * fs / n_fft
    mags = s[bins]
    return pitches, mags


def pitch_tuning(frequencies, resolution=0.01, bins_per_octave=12):
    """Histogram of fractional-bin deviations → dominant tuning offset in
    fractions of a bin, in [-0.5, 0.5)."""
    frequencies = np.atleast_1d(frequencies)
    frequencies = frequencies[frequencies > 0]
    if frequencies.size == 0:
        return 0.0
    # deviation from integer bin positions relative to A440-anchored grid
    octs = np.log2(frequencies / 440.0)
    residual = np.mod(bins_per_octave * octs, 1.0)
    residual[residual >= 0.5] -= 1.0
    bins = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    counts, _ = np.histogram(residual, bins)
    return float(bins[np.argmax(counts)])


def estimate_tuning(y, fs=22050.0, bins_per_octave=12, resolution=0.01,
                    **kwargs):
    """Estimate tuning deviation of ``y`` in fractions of a CQT bin."""
    pitches, mags = piptrack(y, fs=fs, **kwargs)
    if pitches.size == 0:
        return 0.0
    # keep peaks above median magnitude (librosa's default heuristic)
    keep = mags >= np.median(mags)
    return pitch_tuning(pitches[keep], resolution, bins_per_octave)
