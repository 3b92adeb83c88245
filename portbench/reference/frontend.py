"""The HCQT frontend in plain NumPy and PyTorch: tuning estimate,
multirate constant-Q transform, efficient harmonic CQT, log compression.

Written from the published algorithms: librosa's ``estimate_tuning``
(STFT peaks with parabolic interpolation, a histogram of deviations),
the multirate CQT of Schörkhuber & Klapuri as librosa's ``cqt`` runs it
(top-octave kernels, half-band FIR and 2:1 decimation between octaves,
``scale=True``), and the reference's efficient HCQT
(``libdl/data_preprocessing/hcqt.py``: one extended CQT per power-of-two
base harmonic, harmonics taken as octave-shifted slices of it).

The tuning runs in float64 NumPy on the host; the CQT's filtering and
products run in PyTorch on the given device in float32.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

C1_HZ = 32.70319566257483


# -- tuning -----------------------------------------------------------------

def estimate_tuning(y, fs, bins_per_octave, n_fft=2048, hop=512, fmin=150.0,
                    fmax=4000.0, threshold=0.1, resolution=0.01):
    """Tuning deviation of ``y`` in fractions of a CQT bin."""
    pad = n_fft // 2
    yp = np.pad(np.asarray(y, np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(yp) - n_fft) // hop
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    s = np.abs(np.fft.rfft(yp[idx] * win, axis=1)).T
    freqs = np.arange(s.shape[0]) * fs / n_fft
    prev = np.vstack([s[:1], s[:-1]])
    nxt = np.vstack([s[1:], s[-1:]])
    denom = prev - 2 * s + nxt
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (prev - nxt) / denom, 0.0)
    mask = (s > prev) & (s >= nxt) & (s > threshold * s.max(axis=0,
                                                          keepdims=True))
    mask &= (freqs[:, None] >= fmin) & (freqs[:, None] < fmax)
    peaks = np.nonzero(mask)
    if peaks[0].size == 0:
        return 0.0
    pitches = (peaks[0] + shift[peaks]) * fs / n_fft
    mags = s[peaks]
    f = pitches[mags >= np.median(mags)]
    f = f[f > 0]
    if f.size == 0:
        return 0.0
    residual = np.mod(bins_per_octave * np.log2(f / 440.0), 1.0)
    residual[residual >= 0.5] -= 1.0
    edges = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    counts, _ = np.histogram(residual, edges)
    return float(edges[np.argmax(counts)])


# -- the multirate CQT ------------------------------------------------------

def halfband_taps(num_taps=127, beta=8.0):
    """Linear-phase low-pass at a quarter of the sample rate (Kaiser
    window), unit gain at DC."""
    m = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = 0.5 * np.sinc(0.5 * m) * np.kaiser(num_taps, beta)
    return h / h.sum()


def top_octave_bank(fs, f_low, bpo):
    """(n_fft, 2·bpo) float32 ``[Re K | -Im K]`` of the octave
    [f_low, 2·f_low): Hann-windowed complex exponentials of length
    Q·fs/f, L1-normalised, centred in a power-of-two frame; and the
    filter lengths."""
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    freqs = f_low * 2.0 ** (np.arange(bpo) / bpo)
    lengths = q * fs / freqs
    n_fft = int(2 ** math.ceil(math.log2(lengths.max())))
    k = np.zeros((n_fft, bpo), np.complex128)
    for j, (f, l) in enumerate(zip(freqs, lengths)):
        n = int(np.ceil(l))
        t = np.arange(-(n // 2), n - n // 2)
        phi = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)) \
            * np.exp(2j * np.pi * f * t / fs)
        start = n_fft // 2 - n // 2
        k[start:start + n, j] = phi / np.abs(phi).sum()
    bank = np.concatenate([k.real, -k.imag], axis=1).astype(np.float32)
    return bank, lengths, n_fft


def reflect_pad(y, pad):
    """Reflect padding that reflects again where ``pad`` exceeds the
    signal."""
    while pad > 0:
        p = min(pad, y.shape[0] - 1)
        y = F.pad(y.view(1, 1, -1), (p, p), mode="reflect").view(-1)
        pad -= p
    return y


def decimate2(y, taps):
    yp = reflect_pad(y, taps.shape[0] // 2)
    out = F.conv1d(yp.view(1, 1, -1), taps.flip(0).view(1, 1, -1), stride=2)
    return out.view(-1)[:(y.shape[0] + 1) // 2]


def cqt(y, fs, hop, fmin, n_bins, bpo):
    """Magnitude CQT (n_frames, n_bins) of the float32 signal ``y`` (1-D
    tensor), ``n_frames = len(y) // hop + 1``, lowest bin first."""
    n_oct = int(math.ceil(n_bins / bpo))
    bank, lengths, n_fft = top_octave_bank(fs, fmin * 2.0 ** (n_oct - 1),
                                           bpo)
    bank = torch.as_tensor(bank, device=y.device)
    taps = torch.as_tensor(halfband_taps().astype(np.float32),
                           device=y.device)
    n_frames = y.shape[0] // hop + 1
    octaves = []
    for k in range(n_oct):
        yp = reflect_pad(y, n_fft // 2)
        need = (n_frames - 1) * hop + n_fft
        if yp.shape[0] < need:
            yp = F.pad(yp, (0, need - yp.shape[0]))
        ri = yp.unfold(0, n_fft, hop)[:n_frames] @ bank
        mag = torch.sqrt(ri[:, :bpo] ** 2 + ri[:, bpo:] ** 2)
        scale = torch.as_tensor(np.sqrt(lengths * 2.0 ** k).astype(
            np.float32), device=y.device)
        octaves.append(mag * scale)
        if k + 1 < n_oct:
            y = decimate2(y, taps)
            hop //= 2
    return torch.cat(octaves[::-1], dim=1)[:, -n_bins:]


# -- the HCQT ---------------------------------------------------------------

def hop_size(fs, fs_target, n_octaves):
    factor = 2 ** (n_octaves - 1)
    return int(max(1, factor * np.round(fs / fs_target / factor)))


def harmonic_layout(num_harmonics, num_subharmonics):
    """(harmonics, [(base, octave shift)]): each harmonic goes to the
    first base (subharmonics first) of which it is a power-of-two
    multiple."""
    harmonics = [1.0 / (n + 1) for n in range(num_subharmonics, 0, -1)]
    harmonics += [float(n) for n in range(1, num_harmonics + 1)]
    bases, layout = [], []
    for h in harmonics:
        for b in bases:
            r = math.log2(h / b)
            if abs(r - round(r)) < 1e-9 and r >= 0:
                layout.append((b, int(round(r))))
                break
        else:
            bases.append(h)
            layout.append((h, 0))
    return harmonics, layout


def plans(fe, tuning):
    """[(base, fmin, n_bins)] of the extended CQTs, and the hop."""
    bpo, n_oct = fe["bins_per_octave"], fe["num_octaves"]
    nh, ns = fe["num_harmonics"], fe["num_subharmonics"]
    n_eff = n_oct + int(np.ceil(np.log2(ns + 1) + np.log2(nh)))
    hop = hop_size(fe["fs"], fe["fs_hcqt_target"], n_eff)
    fmin = C1_HZ
    if fe.get("center_bins", True):
        fmin = fmin / 2 ** ((bpo // 12 - 1) / (2 * bpo))
    fmin *= 2 ** (tuning / bpo)
    _, layout = harmonic_layout(nh, ns)
    out = []
    for base in sorted({b for b, _ in layout}):
        shift = max(s for b, s in layout if b == base)
        out.append((base, fmin * base, (n_oct + shift) * bpo))
    return out, hop


def hcqt(audio, fe, device):
    """The efficient HCQT (harmonics, T, bins) float32 tensor on
    ``device`` of ``audio`` (1-D float32 numpy), its tuning estimated."""
    bpo, n_bins = fe["bins_per_octave"], fe["bins_per_octave"] * fe[
        "num_octaves"]
    tuning = estimate_tuning(audio, fe["fs"], bpo)
    y = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    ps, hop = plans(fe, tuning)
    by_base = {base: cqt(y, float(fe["fs"]), hop, fmin, nb, bpo)
               for base, fmin, nb in ps}
    _, layout = harmonic_layout(fe["num_harmonics"], fe["num_subharmonics"])
    x = torch.stack([by_base[b][:, s * bpo:s * bpo + n_bins]
                     for b, s in layout])
    return x
