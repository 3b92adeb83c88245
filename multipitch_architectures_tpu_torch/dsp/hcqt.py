"""Harmonic CQT feature frontend.

Counterpart of ``multipitch_architectures_tpu/dsp/hcqt.py``: the
efficient HCQT of the reference (libdl/data_preprocessing/hcqt.py:89-164)
computes one extended CQT per power-of-two "base harmonic" group and takes
harmonics related by 2^k as octave-shifted slices of it. The octaves of
all bases go to the CQT octave kernel as one work list: one launch per
HCQT, or per chunk of a streamed HCQT. ``compute_hcqt`` is the naive
variant, one full CQT per (sub)harmonic (reference hcqt.py:34-85).
"""

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.cqt_octave import cqt_octaves
from ..utils.profiling import counters, span
from .cqt import CqtPlan, as_signal, cqt_chunks, cqt_work_list
from .tuning import estimate_tuning

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
    counters["hcqt.plan_builds"] += 1
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
                          tuning: float = 0.0,
                          chunk_frames: Optional[int] = None,
                          exact: bool = False,
                          device: Optional[torch.device] = None):
    """Efficient HCQT of ``f_audio`` (1-D tensor or array).

    Runs on ``device``. By default a tensor stays where it lies and an
    array goes to the card; with no card an array needs ``device="cpu"``,
    and raises otherwise. ``tuning`` is a fractional-bin offset.
    ``exact=True`` uses per-octave full-rate kernel banks (see
    :class:`CqtPlan`).

    Returns ((n_harm, T, n_bins) float32 in the model layout, fs_hcqt,
    hopsize): a tensor on the device, or with ``chunk_frames`` host numpy
    computed in chunks of that many frames (:func:`..cqt.cqt_chunks`: the
    bounded-memory path for long recordings, one kernel launch per
    chunk).
    """
    y = as_signal(f_audio, device)
    num_octaves_eff = num_octaves + int(
        np.ceil(np.log2(num_subharmonics + 1) + np.log2(num_harmonics)))
    hopsize_cqt, fs_hcqt = compute_hopsize_cqt(fs_hcqt_target, fs=fs,
                                               num_octaves=num_octaves_eff)
    _check_bpo(bins_per_octave)
    fmin = _centered_fmin(fmin, bins_per_octave, center_bins)
    fmin_tuned = fmin * 2 ** (tuning / bins_per_octave)

    n_frames = y.shape[0] // hopsize_cqt + 1
    n_bins = bins_per_octave * num_octaves
    harmonics, assignment = _harmonic_layout(num_harmonics, num_subharmonics)
    bases = sorted({b for b, _ in assignment})
    with span("hcqt.plan"):
        plans = [_plan(float(fs), int(hopsize_cqt), float(fmin_tuned * base),
                       int((num_octaves + max(s for b, s in assignment
                                              if b == base))
                           * bins_per_octave),
                       int(bins_per_octave), exact=exact)
                 for base in bases]
        if not chunk_frames:
            # the bases' octaves (9 + 6 + 6 on the serving path), to go
            # in one launch
            octaves, outs = [], []
            for plan in plans:
                work, out = cqt_work_list(y, plan)
                octaves += work
                outs.append(out)

    def layout(cqts):
        """(n_harm, T, n_bins) from the bases' (T, bins) CQTs."""
        by_base = dict(zip(bases, cqts))
        return torch.stack([by_base[b][:, s * bins_per_octave:
                                       s * bins_per_octave + n_bins]
                            for b, s in assignment])

    if chunk_frames:
        out = np.empty((len(harmonics), n_frames, n_bins), np.float32)
        for c0, c1, cqts in cqt_chunks(y, plans, chunk_frames):
            out[:, c0:c1] = layout(cqts).cpu().numpy()
        return out, fs_hcqt, hopsize_cqt
    with span("hcqt.k1"):
        cqt_octaves(octaves, bpo=int(bins_per_octave))
    return (layout([out[:, -plan.n_bins:] for plan, out in zip(plans, outs)]),
            fs_hcqt, hopsize_cqt)


def compute_efficient_hcqt(f_audio, fs=22050, fmin=C1_HZ, fs_hcqt_target=91,
                           bins_per_octave=60, num_octaves=6, num_harmonics=5,
                           num_subharmonics=1, center_bins=True,
                           tuning: Optional[float] = None,
                           chunk_frames: Optional[int] = None,
                           exact: bool = False,
                           device: Optional[torch.device] = None):
    """Efficient HCQT (reference hcqt.py:89-164) in the reference's layout.

    ``tuning=None`` estimates the tuning offset on the host
    (:func:`..tuning.estimate_tuning`); pass 0.0 to skip it. The HCQT runs
    on ``resolve_device(device)``: the card unless ``device="cpu"``.

    Returns (f_hcqt (n_bins, n_frames, n_harm+n_sub) float32 numpy,
    fs_hcqt, hopsize).
    """
    with span("hcqt"):
        dev = resolve_device(device)
        f_audio = np.asarray(f_audio, np.float32)
        if tuning is None:
            with span("hcqt.tuning"):
                tuning = estimate_tuning(f_audio, fs=fs,
                                         bins_per_octave=bins_per_octave)
        out, fs_hcqt, hopsize_cqt = efficient_hcqt_device(
            f_audio, fs=fs, fmin=fmin, fs_hcqt_target=fs_hcqt_target,
            bins_per_octave=bins_per_octave, num_octaves=num_octaves,
            num_harmonics=num_harmonics, num_subharmonics=num_subharmonics,
            center_bins=center_bins, tuning=float(tuning),
            chunk_frames=chunk_frames, exact=exact, device=dev)
        with span("hcqt.copy"):
            if not chunk_frames:
                out = out.cpu().numpy()
            # (n_harm, T, F) -> the reference's (F, T, n_harm)
            out = np.ascontiguousarray(np.transpose(out, (2, 1, 0)))
    return out, fs_hcqt, hopsize_cqt


def compute_hcqt(f_audio, fs=22050, fmin=C1_HZ, fs_hcqt_target=91,
                 bins_per_octave=60, num_octaves=6, num_harmonics=5,
                 num_subharmonics=1, center_bins=True,
                 tuning: Optional[float] = None,
                 device: Optional[torch.device] = None):
    """Naive HCQT: one full CQT per (sub)harmonic (reference hcqt.py:34-85).
    The six CQTs' octaves form one work list (2 launches of the kernel at
    36 octaves). Tuning and device as :func:`compute_efficient_hcqt`.

    Returns (f_hcqt (n_bins, n_frames, n_harm+n_sub) float32 numpy,
    fs_hcqt, hopsize).
    """
    dev = resolve_device(device)
    f_audio = np.asarray(f_audio, np.float32)
    hopsize_cqt, fs_hcqt = compute_hopsize_cqt(fs_hcqt_target, fs=fs,
                                               num_octaves=num_octaves)
    _check_bpo(bins_per_octave)
    fmin = _centered_fmin(fmin, bins_per_octave, center_bins)
    if tuning is None:
        tuning = estimate_tuning(f_audio, fs=fs,
                                 bins_per_octave=bins_per_octave)
    fmin_tuned = fmin * 2 ** (tuning / bins_per_octave)

    n_bins = num_octaves * bins_per_octave
    harmonics = [1.0 / (n + 1) for n in range(num_subharmonics, 0, -1)]
    harmonics += [float(n) for n in range(1, num_harmonics + 1)]
    y = torch.as_tensor(f_audio, device=dev)
    octaves, mags = [], []
    for h in harmonics:
        plan = _plan(float(fs), int(hopsize_cqt), float(fmin_tuned * h),
                     int(n_bins), int(bins_per_octave))
        work, out = cqt_work_list(y, plan)
        octaves += work
        mags.append(out[:, -n_bins:])                 # (T, n_bins)
    cqt_octaves(octaves, bpo=int(bins_per_octave))
    out = torch.stack(mags, dim=-1).transpose(0, 1)   # (n_bins, T, n_harm)
    return np.ascontiguousarray(out.cpu().numpy()), fs_hcqt, hopsize_cqt


def _check_bpo(bins_per_octave):
    if bins_per_octave % 12:
        raise ValueError(f"bins_per_octave must be a multiple of 12, got "
                         f"{bins_per_octave}")


# the JAX package's name for the same entry point
hcqt = efficient_hcqt_device
