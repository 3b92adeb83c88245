"""Harmonic CQT feature frontend.

Counterpart of ``multipitch_architectures_tpu/dsp/hcqt.py``: the
efficient HCQT of the reference (libdl/data_preprocessing/hcqt.py:89-164)
computes one extended CQT per power-of-two "base harmonic" group and takes
harmonics related by 2^k as octave-shifted slices of it. The octaves of
all bases go to the CQT octave kernel as one work list: one launch per
HCQT.
"""

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..ops.cqt_octave import cqt_octaves
from .cqt import CqtPlan, cqt_work_list

C1_HZ = 32.70319566257483  # librosa.note_to_hz('C1')


def compute_hopsize_cqt(fs_cqt_target, fs=22050, num_octaves=7):
    """CQT hopsize approximating a target frame rate, constrained to a
    multiple of 2^(num_octaves-1) (reference hcqt.py:9-30)."""
    factor = 2 ** (num_octaves - 1)
    n = np.round(fs / fs_cqt_target / factor)
    hopsize_cqt = int(max(1, factor * n))
    return hopsize_cqt, fs / hopsize_cqt


def _centered_fmin(fmin, bins_per_octave, center_bins):
    """Shift fmin down so bin centers align to MIDI pitches when using
    several bins per semitone (reference hcqt.py:60-61, 119-120)."""
    if not center_bins:
        return fmin
    bins_per_semitone = bins_per_octave // 12
    return fmin / 2 ** ((bins_per_semitone - 1) / (2 * bins_per_octave))


@lru_cache(maxsize=32)
def _plan(fs, hop, fmin, n_bins, bins_per_octave, exact=False):
    return CqtPlan.create(fs, hop, fmin, n_bins, bins_per_octave,
                          exact=exact)


def _harmonic_layout(num_harmonics, num_subharmonics):
    """Group (sub)harmonics by power-of-two base, like the reference's
    base-harmonic search (hcqt.py:129-148): each harmonic h is assigned the
    first base b (in list order, subharmonics first) with h/b = 2^k.
    Returns (harmonics, [(base, octave shift) per harmonic])."""
    harmonics = [1.0 / (n + 1) for n in range(num_subharmonics, 0, -1)]
    harmonics += [float(n) for n in range(1, num_harmonics + 1)]
    bases = []
    assignment = []
    for h in harmonics:
        for b in bases:
            r = math.log2(h / b)
            if abs(r - round(r)) < 1e-9 and r >= 0:
                assignment.append((b, int(round(r))))
                break
        else:
            bases.append(h)
            assignment.append((h, 0))
    return harmonics, assignment


def efficient_hcqt_device(f_audio, fs=22050, fmin=C1_HZ, fs_hcqt_target=91,
                          bins_per_octave=60, num_octaves=6, num_harmonics=5,
                          num_subharmonics=1, center_bins=True,
                          tuning: float = 0.0, exact: bool = False,
                          device: Optional[torch.device] = None):
    """Efficient HCQT of ``f_audio`` (1-D tensor or array).

    Runs on ``device``. By default a tensor stays where it lies and an
    array goes to the card (``cuda``); with no card an array needs
    ``device="cpu"``, and raises otherwise. ``tuning`` is a fractional-bin
    offset. ``exact=True`` uses per-octave full-rate kernel banks (see
    :class:`CqtPlan`).

    Returns ((n_harm, T, n_bins) float32 tensor in the model layout,
    fs_hcqt, hopsize).
    """
    if device is None and not isinstance(f_audio, torch.Tensor):
        if not torch.cuda.is_available():
            raise RuntimeError("hcqt runs on the card by default and there "
                               "is none: pass device='cpu' to run on the CPU")
        device = torch.device("cuda")
    num_octaves_eff = num_octaves + int(
        np.ceil(np.log2(num_subharmonics + 1) + np.log2(num_harmonics)))
    hopsize_cqt, fs_hcqt = compute_hopsize_cqt(fs_hcqt_target, fs=fs,
                                               num_octaves=num_octaves_eff)
    if bins_per_octave % 12:
        raise ValueError(f"bins_per_octave must be a multiple of 12, got "
                         f"{bins_per_octave}")
    fmin = _centered_fmin(fmin, bins_per_octave, center_bins)
    fmin_tuned = fmin * 2 ** (tuning / bins_per_octave)

    y = torch.as_tensor(f_audio, dtype=torch.float32, device=device)
    n_frames = y.shape[0] // hopsize_cqt + 1
    n_bins = bins_per_octave * num_octaves
    harmonics, assignment = _harmonic_layout(num_harmonics, num_subharmonics)

    # the bases' octaves (9 + 6 + 6 on the serving path) in one launch
    bases, octaves = [], []
    for base in sorted({b for b, _ in assignment}):
        max_shift = max(s for b, s in assignment if b == base)
        plan = _plan(float(fs), int(hopsize_cqt), float(fmin_tuned * base),
                     int((num_octaves + max_shift) * bins_per_octave),
                     int(bins_per_octave), exact=exact)
        work, out = cqt_work_list(y, plan)
        octaves += work
        bases.append((base, plan, out))
    cqt_octaves(octaves, bpo=int(bins_per_octave))

    channels = [None] * len(harmonics)
    for base, plan, out in bases:
        f_cqt = out[:, -plan.n_bins:].T               # (bins, T)
        for idx, (b, shift) in enumerate(assignment):
            if b == base:
                lo = shift * bins_per_octave
                channels[idx] = f_cqt[lo:lo + n_bins, :n_frames].T  # (T, F)
    return torch.stack(channels), fs_hcqt, hopsize_cqt


# the JAX package's name for the same entry point
hcqt = efficient_hcqt_device
