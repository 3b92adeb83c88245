"""Inputs made from the run's seed: synthetic polyphonic audio, and a
synthetic training corpus of HCQT features and pitch targets."""

import numpy as np
import torch

from .common import stream


def note_events(rng, seconds, voices):
    """(start s, end s, MIDI pitch 24..96, voice) of ``voices`` monophonic
    voices: notes of 0.15-1.2 s, rests of up to 0.4 s."""
    events = []
    for v in range(voices):
        t = rng.uniform(0, 0.5)
        while t < seconds - 0.2:
            end = min(seconds, t + rng.uniform(0.15, 1.2))
            events.append((t, end, int(rng.integers(24, 97)), v,
                           rng.uniform(0.3, 1.0)))
            t = end + rng.uniform(0.0, 0.4)
    return events


def synth(seconds, rng, fs, device, max_voices=4):
    """Mono float32 numpy audio at ``fs``: 1..``max_voices`` voices, each
    note 5 harmonic partials (amplitudes 0.6^k) at a random level with
    10-ms smoothed edges; peak 0.9. Made on ``device`` in float64."""
    n = int(seconds * fs)
    voices = int(rng.integers(1, max_voices + 1))
    events = note_events(rng, seconds, voices)
    freq = np.zeros((voices, n))
    gate = np.zeros((voices, n))
    for start, end, midi, v, level in events:
        s0, s1 = int(start * fs), int(end * fs)
        freq[v, s0:s1] = 440.0 * 2.0 ** ((midi - 69) / 12)
        gate[v, s0:s1] = level
    f = torch.as_tensor(freq, device=device)
    g = torch.as_tensor(gate, device=device)
    ramp = torch.hann_window(int(0.02 * fs), dtype=torch.float64,
                             device=device)
    ramp = (ramp / ramp.sum()).view(1, 1, -1)
    phase = torch.cumsum(2 * np.pi * f / fs, dim=1)
    tone = sum(0.6 ** k * torch.sin((k + 1) * phase) for k in range(5))
    env = torch.nn.functional.conv1d(g[:, None], ramp, padding="same")[:, 0]
    y = (tone * env).sum(0)
    y *= 0.9 / y.abs().max().clamp_min(1e-12)
    return y.float().cpu().numpy()


def audio_pool(lengths, seed, fs, device):
    """One recording per length (seconds), from the seed."""
    rng = stream(seed, 3)
    return [synth(s, rng, fs, device) for s in lengths]


def training_corpus(lengths_frames, seed, device, n_bins_in=216,
                    n_bins_out=72, min_pitch=24, max_poly=4):
    """[(features (6, T, 216), targets (T, 72))] float32 numpy, one per
    length: notes of 10-40 frames, 1..``max_poly`` at once, MIDI 30-89;
    an active pitch p lights bin 3·(p - 24) + 1 and its (sub)harmonics'
    bins in the 6 channels with weight 1/(1 + c), over uniform noise of
    0.05. Features are made on ``device``."""
    rng = stream(seed, 4)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 63 - 1)))
    offsets = np.array([-36, 0, 36, 57, 72, 83])
    files = []
    for t_len in lengths_frames:
        roll = np.zeros((t_len, 128), np.float32)
        t = 0
        while t < t_len:
            dur = int(rng.integers(10, 40))
            pitches = rng.choice(np.arange(30, 90),
                                 int(rng.integers(1, max_poly + 1)),
                                 replace=False)
            roll[t:t + dur, pitches] = 1.0
            t += dur
        r = torch.as_tensor(roll, device=device)
        x = 0.05 * torch.rand((6, t_len, n_bins_in), generator=gen,
                              device=device)
        bins = 3 * (np.arange(128) - 24) + 1
        for c, off in enumerate(offsets):
            b = bins + off
            ok = (b >= 0) & (b < n_bins_in)
            x[c].index_add_(1, torch.as_tensor(b[ok], device=device),
                            r[:, torch.as_tensor(np.nonzero(ok)[0],
                                                 device=device)] / (1 + c))
        files.append((x.cpu().numpy(),
                      roll[:, min_pitch:min_pitch + n_bins_out].copy()))
    return files
