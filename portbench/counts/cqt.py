"""Operations and bytes of one HCQT through the CQT octave kernel (K1),
from the configuration's frontend and the recording's length.

The efficient HCQT runs one extended multirate CQT per power-of-two base
harmonic (bases 1/2, 3 and 5 for harmonics 1/2, 1..5: 9, 6 and 6
octaves). Each octave k of a base's CQT frames its signal, decimated k
times, into the recording's T frames of ``n_fft`` samples (the top
octave's power-of-two kernel length) and multiplies them by the
(n_fft, 2·bpo) bank ``[Re | -Im]``, then takes the magnitude and scales
it:

- FLOPs: 2·T·n_fft·2·bpo for the product (counted once, in float32:
  the kernel's three split-TF32 products are its own choice) and 4·T·bpo
  for the magnitude and scale;
- bytes: each input byte read once and each output byte written once,
  in float32: the octave's padded signal, its bank and scale, and its
  T x bpo outputs.

The plans' kernel lengths do not depend on the tuning estimate (a shift
of under half a bin moves no length across a power of two), so the count
takes tuning 0.
"""

import math

from ..reference import frontend


def octaves(fe, n_samples):
    """[(n_fft, signal length after padding, n_frames)] of each octave
    of each base's CQT."""
    plans, hop = frontend.plans(fe, 0.0)
    bpo = fe["bins_per_octave"]
    t = n_samples // hop + 1
    out = []
    for _, fmin, n_bins in plans:
        n_oct = int(math.ceil(n_bins / bpo))
        _, _, n_fft = frontend.top_octave_bank(
            fe["fs"], fmin * 2.0 ** (n_oct - 1), bpo)
        length = n_samples
        for _ in range(n_oct):
            out.append((n_fft, length + 2 * (n_fft // 2), t))
            length = (length + 1) // 2
    return out


def product_flops(fe, n_samples):
    """FLOPs of the HCQT's frame-by-bank products alone."""
    bpo = fe["bins_per_octave"]
    return sum(2 * t * n_fft * 2 * bpo
               for n_fft, _, t in octaves(fe, n_samples))


def hcqt_cost(fe, n_samples):
    """(FLOPs, bytes) of one HCQT of ``n_samples`` samples."""
    bpo = fe["bins_per_octave"]
    flops = nbytes = 0
    for n_fft, length, t in octaves(fe, n_samples):
        flops += 2 * t * n_fft * 2 * bpo + 4 * t * bpo
        nbytes += 4 * (length + n_fft * 2 * bpo + bpo + t * bpo)
    return flops, nbytes
