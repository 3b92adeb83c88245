"""The port's feature path from audio against the JAX package's, on the
CPU (each CQT octave through the kernel's plain version): the tuning
estimate, both rasterizers, the direct-DFT oracle, the streamed CQT, the
efficient and naive HCQT with the tuning estimated, ``AudioCorpus``, a
``run_experiment`` on it, and the precompute CLI. Audio is 2-3 s of
seeded numpy; files are written under ``tmp_path``.

Tolerances: host numpy code (tuning, rasterizers, oracle) must be equal;
features rel-to-peak 1e-5 (float32 sums in another order, as
tests/test_torch_dsp.py); a streamed CQT against the whole one
rel-to-peak 1e-5 (the decimating convolution over another length may
round otherwise; on the CPU it is exact).
"""

import dataclasses
import logging
import math
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from multipitch_architectures_tpu import dsp as jdsp
from multipitch_architectures_tpu.experiments import AudioCorpus as JAudio
from multipitch_architectures_tpu_torch import dsp, set_f32_parity
from multipitch_architectures_tpu_torch.experiments import (
    AudioCorpus, NpyCorpus, load_experiment, run_experiment,
    shrink_for_smoke)
from multipitch_architectures_tpu_torch.experiments import precompute

FS = 22050
TOL = 1e-5
HCQT_KW = dict(fs_hcqt_target=50, bins_per_octave=36, num_octaves=6)
# a geometry whose base-0.5 plan needs 18,816 samples of context, so that
# 3 s in chunks of 48 frames (hop 448) stream in 4 chunks of real context
SMALL_HCQT = dict(fs_hcqt_target=50, bins_per_octave=12, num_octaves=2)
EXP180D = "exp180d_musicnet_unet_extremelylarge_doubleselfattn"
tcqt = sys.modules["multipitch_architectures_tpu_torch.dsp.cqt"]
tharm = sys.modules["multipitch_architectures_tpu_torch.dsp.hcqt"]


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def chord(seconds=3.0, detune_bins=0.0, seed=0):
    """C4, E4 and A4 detuned by ``detune_bins`` of 36 per octave, with a
    little seeded noise."""
    t = np.arange(int(seconds * FS)) / FS
    shift = 2.0 ** (detune_bins / 36)
    y = sum(a * np.sin(2 * np.pi * f * shift * t)
            for a, f in ((1.0, 261.6256), (0.5, 329.6276), (0.25, 440.0)))
    y = y + 1e-3 * np.random.RandomState(seed).randn(len(t))
    return (0.3 * y).astype(np.float32)


@pytest.mark.parametrize("kind", ["chord", "noise", "silence"])
def test_estimate_tuning_matches_jax(kind):
    """The float64 host copy: the same estimate, bit for bit; a +0.3-bin
    detune reads as such within 0.15 bin (tests/test_dsp.py:141)."""
    y = {"chord": chord(detune_bins=0.3),
         "noise": np.random.RandomState(3).randn(2 * FS).astype(np.float32),
         "silence": np.zeros(FS, np.float32)}[kind]
    got = dsp.estimate_tuning(y, fs=FS, bins_per_octave=36)
    assert got == jdsp.estimate_tuning(y, fs=FS, bins_per_octave=36)
    if kind == "chord":
        assert abs(got - 0.3) < 0.15


EVENTS = np.array([[0.0, 0.5, 60.0], [0.5, 1.0, 60.0],
                   [1.2, 1.21, 72.0],               # vanishing: repaired
                   [1.21, 1.215, 73.0],             # shares its end frame
                   [1.3, 2.6, 61.5], [2.0, 2.01, 40.0]])


@pytest.mark.parametrize("annot_type", ["pitch", "pitch_class",
                                        "instruments"])
@pytest.mark.parametrize("shorten", [1.0, 0.5])
def test_rasterizers_match_jax(annot_type, shorten):
    fs_a = 43.06640625
    got = dsp.compute_annotation_array_nooverlap(EVENTS, 120, fs_a,
                                                 annot_type, shorten=shorten)
    want = jdsp.compute_annotation_array_nooverlap(EVENTS, 120, fs_a,
                                                   annot_type,
                                                   shorten=shorten)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        dsp.compute_annotation_array(EVENTS, 120, fs_a, annot_type),
        jdsp.compute_annotation_array(EVENTS, 120, fs_a, annot_type))
    empty = np.zeros((0, 3))
    np.testing.assert_array_equal(
        dsp.compute_annotation_array_nooverlap(empty, 10, fs_a, annot_type),
        jdsp.compute_annotation_array_nooverlap(empty, 10, fs_a,
                                                annot_type))


def test_cqt_direct_numpy_matches_jax():
    y = chord(0.25)
    kw = dict(fs=FS, hop=512, fmin=130.81, n_bins=48, bins_per_octave=24)
    np.testing.assert_array_equal(dsp.cqt_direct_numpy(y, **kw),
                                  jdsp.cqt_direct_numpy(y, **kw))


@pytest.mark.parametrize("exact", [False, True])
def test_cqt_streamed_matches_whole_and_jax(exact):
    """Chunks of 48 frames with real context (tests/test_dsp.py's
    geometry: 32 or 40 frames of context at hop 64) against the whole
    CQT, and against the JAX package's streamed CQT."""
    fs, hop = 4096, 64
    kw = dict(fs=fs, hop=hop, fmin=100.0, n_bins=108, bins_per_octave=36,
              exact=exact)
    plan = dsp.CqtPlan.create(**kw)
    assert tcqt.cqt_context(plan) == (2048 if exact else 2560)
    y = np.random.RandomState(0).randn(fs * 3).astype(np.float32)
    whole = dsp.cqt(torch.from_numpy(y), plan).numpy()
    streamed = dsp.cqt_streamed(y, plan, chunk_frames=48, device="cpu")
    assert isinstance(streamed, np.ndarray) and streamed.shape == whole.shape
    assert _rel(streamed, whole) < TOL
    want = jdsp.cqt_streamed(y, jdsp.CqtPlan.create(**kw), chunk_frames=48)
    assert _rel(streamed, np.asarray(want)) < TOL


def test_cqt_streamed_matches_the_committed_oracle():
    """The golden 4-s clip streamed in chunks of 64 frames: the exact plan
    within 1e-4 of the float64 direct oracle on every frame, the
    multirate plan within 1e-3 on interior frames (tests/test_dsp.py:
    224-277)."""
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "cqt_direct_oracle_4s.npz"))
    kw = dict(fs=int(g["fs"]), hop=int(g["hop"]), fmin=float(g["fmin"]),
              n_bins=int(g["n_bins"]),
              bins_per_octave=int(g["bins_per_octave"]))
    exact = dsp.cqt_streamed(g["audio"], dsp.CqtPlan.create(**kw, exact=True),
                             chunk_frames=64, device="cpu")
    multirate = dsp.cqt_streamed(g["audio"], dsp.CqtPlan.create(**kw),
                                 chunk_frames=64, device="cpu")
    assert _rel(exact, g["oracle"]) < 1e-4
    interior = np.s_[:, 20:-20]
    assert _rel(multirate[interior], g["oracle"][interior]) < 1e-3


@pytest.mark.parametrize("geometry,chunk", [(HCQT_KW, None),
                                            (HCQT_KW, 32),
                                            (SMALL_HCQT, None),
                                            (SMALL_HCQT, 48)])
def test_compute_efficient_hcqt_matches_jax(geometry, chunk):
    """The tuning estimated (a +0.3-bin chord), whole and streamed: the
    reference layout (F, T, 6) as numpy, rel-to-peak 1e-5 to the JAX
    package; streamed equal to the port's whole HCQT within 1e-5."""
    y = chord(detune_bins=0.3, seed=1)
    got, fs_h, hop = dsp.compute_efficient_hcqt(y, chunk_frames=chunk,
                                                device="cpu", **geometry)
    want, fs_w, hop_w = jdsp.compute_efficient_hcqt(y, chunk_frames=chunk,
                                                    **geometry)
    assert (fs_h, hop) == (fs_w, hop_w)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (
        geometry["bins_per_octave"] * geometry["num_octaves"],
        len(y) // hop + 1, 6)
    assert _rel(got, want) < TOL
    if chunk:
        whole = dsp.compute_efficient_hcqt(y, device="cpu", **geometry)[0]
        assert _rel(got, whole) < TOL


def test_streamed_hcqt_runs_one_work_list_per_chunk(monkeypatch):
    """Every base's octaves of a chunk go to the kernel in one call: 4
    chunks, 4 calls of 5 + 2 + 2 octaves (the small geometry); the naive
    HCQT's six CQTs in one call of 36."""
    calls = []
    real = tcqt.cqt_octaves

    def spy(octaves, *, bpo):
        calls.append(len(octaves))
        real(octaves, bpo=bpo)

    monkeypatch.setattr(tcqt, "cqt_octaves", spy)
    monkeypatch.setattr(tharm, "cqt_octaves", spy)
    y = chord(seed=2)
    dsp.efficient_hcqt_device(y, tuning=0.0, chunk_frames=48, device="cpu",
                              **SMALL_HCQT)
    assert calls == [9] * 4
    calls.clear()
    dsp.compute_hcqt(y, tuning=0.0, device="cpu", **HCQT_KW)
    assert calls == [36]


def test_compute_hcqt_matches_jax():
    """The naive HCQT, one CQT per (sub)harmonic, tuning estimated."""
    y = chord(detune_bins=-0.2, seed=4)
    got, fs_h, hop = dsp.compute_hcqt(y, device="cpu", **HCQT_KW)
    want, fs_w, hop_w = jdsp.compute_hcqt(y, **HCQT_KW)
    assert (fs_h, hop) == (fs_w, hop_w) == (FS / 448, 448)
    assert got.shape == want.shape == (216, len(y) // 448 + 1, 6)
    assert got.dtype == np.float32
    assert _rel(got, want) < TOL


def _clip_files(root, annot_dir="csv", text=None, names=("clip",),
                seconds=2.0):
    """tests/test_experiments.py:301's fixture: a 440-Hz int16 WAV per
    name and a MusicNet csv (or ``text``) beside it."""
    (root / "audio").mkdir(exist_ok=True)
    (root / annot_dir).mkdir(exist_ok=True)
    t = np.arange(int(FS * seconds)) / FS
    for i, name in enumerate(names):
        audio = (0.5 * np.sin(2 * np.pi * 440 * 2 ** (i / 12) * t))
        wavfile.write(root / "audio" / f"{name}.wav", FS,
                      (audio * 32767).astype(np.int16))
        ext = "txt" if text else "csv"
        (root / annot_dir / f"{name}.{ext}").write_text(
            text or "start_time,end_time,instrument,note\n"
                    f"0,44100,1,{69 + i}\n22050,66150,1,72\n")


@pytest.mark.parametrize("schema", [None, "phenicx"])
def test_audio_corpus_matches_jax(tmp_path, schema):
    """The fixtures of tests/test_experiments.py:301 (MusicNet csv) and
    :397 (PHENICX .txt through ``annotation_schema``): features within
    rel-to-peak 1e-5 of the JAX AudioCorpus, rolls equal; the cache hands
    back the same arrays."""
    text = "onset,offset,note\n0.0,1.0,A4\n0.5,1.5,C5\n" if schema else None
    _clip_files(tmp_path, "ann", text=text)
    corpus = AudioCorpus(str(tmp_path / "audio"), str(tmp_path / "ann"),
                         annotation_schema=schema, device="cpu")
    assert corpus.files() == ["clip.wav"]
    inputs, targets = corpus.load("clip.wav")
    want_in, want_t = JAudio(str(tmp_path / "audio"), str(tmp_path / "ann"),
                             annotation_schema=schema).load("clip.wav")
    assert inputs.shape == want_in.shape == (6, 2 * FS // 512 + 1, 216)
    assert inputs.dtype == targets.dtype == np.float32
    assert _rel(inputs, want_in) < TOL
    np.testing.assert_array_equal(targets, want_t)
    assert targets[:, 69].any() and targets[:, 72].any()
    assert corpus.load("clip.wav")[0] is inputs


def test_audio_corpus_cache_is_bounded_by_bytes(tmp_path):
    """tests/test_experiments.py:535: a cap that fits one recording keeps
    one, evicting the least recently used, and loads stay correct."""
    _clip_files(tmp_path, names=("c0", "c1"), seconds=1.0)
    args = (str(tmp_path / "audio"), str(tmp_path / "csv"))
    unbounded = AudioCorpus(*args, cache_bytes=None, device="cpu")
    want = {fn: unbounded.load(fn) for fn in unbounded.files()}
    assert sorted(want) == ["c0.wav", "c1.wav"]
    one = want["c0.wav"][0].nbytes + want["c0.wav"][1].nbytes
    corpus = AudioCorpus(*args, cache_bytes=int(one * 1.5), device="cpu")
    for _ in range(2):
        for fn in corpus.files():
            got = corpus.load(fn)
            np.testing.assert_array_equal(got[0], want[fn][0])
            np.testing.assert_array_equal(got[1], want[fn][1])
            assert corpus._cache_nbytes <= corpus.cache_bytes
    assert list(corpus._cache) == ["c1.wav"]
    off = AudioCorpus(*args, cache=False, device="cpu")
    assert off.load("c0.wav")[0] is not off.load("c0.wav")[0]


def _split_corpus(root):
    """exp180d's split prefixes: 2 train files, 1 val (1729_), 1 test
    (2303_), 3 s each."""
    _clip_files(root, names=("train000_a", "train001_b", "1729_val",
                             "2303_test"), seconds=3.0)
    return str(root / "audio"), str(root / "csv")


def test_run_experiment_on_audio_corpus(tmp_path):
    cfg = shrink_for_smoke(load_experiment(EXP180D))
    cfg = dataclasses.replace(cfg, train_config=dataclasses.replace(
        cfg.train_config, max_train_batches=2))
    corpus = AudioCorpus(*_split_corpus(tmp_path), device="cpu")
    out = str(tmp_path / "run")
    res = run_experiment(cfg, corpus, out, max_epochs_override=1,
                         logger=logging.getLogger("test.audio"),
                         device="cpu")
    assert len(res["history"]["train_loss"]) == 1
    assert [s["n_files"] for s in res["subsets"]] == [1, 1, 1]
    for agg in res["subsets"]:
        assert all(math.isfinite(v) for v in agg["framewise_mean"].values())
    pred = np.load(os.path.join(out, "predictions", cfg.name,
                                "2303_test.npy"))
    assert pred.shape == (3 * FS // 512 + 1, 72)


def test_precompute_cli_output_loads_as_audio_corpus(tmp_path, capsys):
    """``--cpu``: NpyCorpus over the written files gives what
    AudioCorpus.load gives, bit for bit, in the reference's layouts."""
    audio_dir, csv_dir = _split_corpus(tmp_path)
    out = tmp_path / "out"
    assert precompute.main(["--audio-dir", audio_dir, "--csv-dir", csv_dir,
                            "--out-dir", str(out), "--chunk-frames", "64",
                            "--cpu"]) == 0
    assert "2303_test: hcqt (216, 130, 6), roll (128, 130)" in \
        capsys.readouterr().out
    npy = NpyCorpus(str(out / "hcqt"), str(out / "pitch"))
    audio = AudioCorpus(audio_dir, csv_dir, chunk_frames=64, device="cpu")
    assert [os.path.splitext(f)[0] for f in npy.files()] == \
        [os.path.splitext(f)[0] for f in audio.files()]
    for fn in audio.files():
        name = os.path.splitext(fn)[0]
        assert np.load(out / "hcqt" / f"{name}.npy").dtype == np.float32
        for a, b in zip(npy.load(name + ".npy"), audio.load(fn)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):
        precompute.main(["--audio-dir", audio_dir, "--csv-dir", csv_dir,
                         "--out-dir", str(out), "--schema", "nope", "--cpu"])


def test_cli_trains_from_audio(monkeypatch, tmp_path):
    """``--audio-dir/--csv-dir/--chunk-frames/--schema`` build the
    AudioCorpus; an unknown schema and a missing ``--csv-dir`` stop the
    CLI before any work."""
    from multipitch_architectures_tpu_torch import experiments
    from multipitch_architectures_tpu_torch.experiments import run as cli

    seen = {}
    monkeypatch.setattr(experiments, "run_experiment",
                        lambda cfg, corpus, out, **kw: seen.update(
                            corpus=corpus, **kw) or {})
    assert cli.main(["--config", EXP180D, "--audio-dir", "a", "--csv-dir",
                     "c", "--chunk-frames", "4096", "--schema", "bach10",
                     "--cpu", "--out-dir", str(tmp_path)]) == 0
    corpus = seen["corpus"]
    assert isinstance(corpus, AudioCorpus) and seen["device"] == "cpu"
    assert (corpus.audio_dir, corpus.csv_dir, corpus.chunk_frames,
            corpus.annotation_schema) == ("a", "c", 4096, "bach10")
    assert corpus.device == torch.device("cpu")
    for argv in (["--schema", "nope", "--audio-dir", "a", "--csv-dir", "c"],
                 ["--audio-dir", "a"]):
        with pytest.raises(SystemExit):
            cli.main(["--config", EXP180D, "--cpu", *argv])
