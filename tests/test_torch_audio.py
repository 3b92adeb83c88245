"""The port's audio and note-event readers against the JAX package's, on
tiny files written under ``tmp_path``: ``load_audio`` for every WAV
sample format, stereo, resampled and ``.npy``; ``load_note_events`` (the
port parses without pandas) for both auto-detected schemas and every
preset, equal to the JAX (pandas) reader's array exactly."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from scipy.io import wavfile

from multipitch_architectures_tpu import io as jio
from multipitch_architectures_tpu_torch import io as tio

FS = 22050


def _sig(n, seed=0, channels=1):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / FS
    y = 0.5 * np.sin(2 * np.pi * 440 * t)[:, None] + 0.1 * rng.randn(
        n, channels)
    return np.clip(y, -0.99, 0.99)[:, 0] if channels == 1 else np.clip(
        y, -0.99, 0.99)


def _wav(path, rate, data):
    wavfile.write(path, rate, data)
    return str(path)


@pytest.mark.parametrize("fmt", ["int16", "int32", "uint8", "float32",
                                 "float64"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate", [FS, 44100, 16000])
def test_load_audio_matches_jax(tmp_path, fmt, channels, rate):
    """Every sample format, mono and stereo, at the target rate and
    resampled up and down by ``resample_poly``: the same float32 array."""
    y = _sig(rate // 4, seed=channels, channels=channels)
    if fmt.startswith("int"):
        data = (y * np.iinfo(fmt).max).astype(fmt)
    elif fmt == "uint8":
        data = np.round(y * 127 + 128).astype(np.uint8)
    else:
        data = y.astype(fmt)
    path = _wav(tmp_path / "a.wav", rate, data)
    got = tio.load_audio(path, FS)
    want = jio.load_audio(path, FS)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.ndim == 1
    np.testing.assert_array_equal(got, want)


def test_load_audio_npy_and_unsupported(tmp_path, monkeypatch):
    y = _sig(1000).astype(np.float64)
    np.save(tmp_path / "a.npy", y)
    got = tio.load_audio(str(tmp_path / "a.npy"))
    np.testing.assert_array_equal(got, jio.load_audio(str(tmp_path /
                                                          "a.npy")))
    assert got.dtype == np.float32
    # an unknown sample kind raises in both packages
    monkeypatch.setattr(wavfile, "read",
                        lambda p: (FS, np.zeros(10, np.complex64)))
    for pkg in (tio, jio):
        with pytest.raises(ValueError, match="unsupported"):
            pkg.load_audio("x.wav")


def test_note_name_to_midi_matches_jax():
    for name in ["A4", "C4", "C#4", "Db4", "c-1", "G9", " Bb3 ", "B#2",
                 "Cb0"]:
        assert tio.note_name_to_midi(name) == jio.note_name_to_midi(name)
    assert tio.note_name_to_midi("A4") == 69.0
    for bad in ["H4", "A", "4", "A#b4"]:
        with pytest.raises(ValueError):
            tio.note_name_to_midi(bad)


def test_schema_presets_match_jax():
    assert tio.NOTE_EVENT_SCHEMAS.keys() == jio.NOTE_EVENT_SCHEMAS.keys()
    for key, schema in jio.NOTE_EVENT_SCHEMAS.items():
        assert vars(tio.NOTE_EVENT_SCHEMAS[key]) == vars(schema)


# (file name, text, schema): every auto-detected schema and preset, with
# the cases pandas handles on its own: blank lines (also trailing), spaces
# around fields, \r\n endings, a header-less Bach10 file, missing fields
FILES = [
    ("musicnet.csv",
     "start_time,end_time,instrument,note,start_beat,end_beat,note_value\n"
     "9182,90078,43,53,4.0,1.5,Dotted Quarter\n"
     "9182,33758,42,65,4.0,0.5,Eighth\n\n"
     "33758, 57822 ,42,69,4.5,0.5,Eighth\n\n", None),
    ("musicnet_crlf.csv",
     "start_time,end_time,instrument,note\r\n0,44100,1,69\r\n"
     "22050,66150,1,72\r\n", None),
    # no start_time/end_time/note header: positional columns 0, 1 and 3
    ("positional.csv", "a,b,c,d\n0,44100,1,69\n44100,88200,1,70.0\n", None),
    ("swd.csv", "start;end;pitch;instrument\n0.5;1.25;60;voice\n"
     "1.25;2.0;62.0;piano\n", None),
    ("swd_case.csv", " Start ; END;Pitch\n0.1;0.2;40\n", None),
    ("musicnet_preset.csv", "start_time,end_time,instrument,note\n"
     "0,44100,1,69\n", "musicnet"),
    ("swd_preset.csv", "start;end;pitch\n0.5;1.0;69\n", "swd"),
    ("bach10.txt", "  500 1000 69\n1000\t2000   72\n\n", "bach10"),
    ("bach10_header.txt", "onset offset midi\n500 1000 69\n", "bach10"),
    ("phenicx.txt", "onset,offset,note\n0.917,1.476,A4\n1.0,2.0, C#5\n\n",
     "phenicx"),
    ("phenicx_noheader.txt", "0.5,1.0,Bb3\n", "phenicx"),
    ("csd.csv", "".join(f"{0.5 + 0.01 * i:.3f},{f:.2f}\n" for i, f in
                        enumerate([0.0] * 3 + [440.0] * 5 + [0.0, 523.25]
                                  + [0.0] * 2)) + "\n", "csd"),
    ("csd_header.csv", "time,f0\n0.1,220.0\n0.2,0\n0.3,-5\n", "csd"),
    ("csd_one.csv", "0.1,220.0\n", "csd"),
    ("missing.csv", "start_time,end_time,instrument,note\n0,44100,1,\n"
     ",,,\n0,NaN,1,60\n", None),
]


@pytest.mark.parametrize("name,text,schema", FILES,
                         ids=[f[0] for f in FILES])
def test_load_note_events_matches_pandas_reader(tmp_path, name, text,
                                                schema):
    path = tmp_path / name
    path.write_bytes(text.encode())
    got = tio.load_note_events(str(path), schema=schema)
    want = jio.load_note_events(str(path), schema=schema)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_note_events_custom_schema_and_source_fs(tmp_path):
    """A custom column map (sample indices at 48 kHz, Hz pitch) and the
    auto path's ``source_fs``."""
    path = tmp_path / "custom.csv"
    path.write_text("s,e,f\n24000,48000,440.0\n48000,96000,523.25\n")
    schema = jio.NoteEventSchema(sep=",", onset="s", offset="e", pitch="f",
                                 time_unit="samples", source_fs=48000.0,
                                 pitch_unit="hz")
    got = tio.load_note_events(str(path), schema=tio.NoteEventSchema(
        **vars(schema)))
    np.testing.assert_array_equal(got, jio.load_note_events(
        str(path), schema=schema))
    np.testing.assert_array_equal(got, [[0.5, 1.0, 69.0], [1.0, 2.0, 72.0]])
    path = tmp_path / "mn.csv"
    path.write_text("start_time,end_time,instrument,note\n0,48000,1,69\n")
    np.testing.assert_array_equal(
        tio.load_note_events(str(path), source_fs=48000.0),
        jio.load_note_events(str(path), source_fs=48000.0))


_event = st.tuples(st.integers(0, 10 ** 7), st.integers(1, 10 ** 6),
                   st.integers(0, 127))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(events=st.lists(_event, max_size=30),
       decimals=st.integers(0, 6), sep=st.sampled_from([",", ";"]),
       seconds=st.booleans())
def test_random_event_tables_match_pandas_reader(tmp_path, events,
                                                 decimals, sep, seconds):
    """Random MusicNet tables (integer sample indices) and SWD tables
    (decimal seconds, up to 6 decimals) through the auto-detect path."""
    if seconds:
        sep = ";"
        lines = ["start;end;pitch"] + [
            f"{s / 44100:.{decimals}f};{(s + d) / 44100:.{decimals}f};{p}"
            for s, d, p in events]
    else:
        lines = [sep.join(["start_time", "end_time", "instrument",
                           "note"])] + [
            sep.join(map(str, (s, s + d, 1, p))) for s, d, p in events]
    path = tmp_path / "events.csv"
    path.write_text("\n".join(lines) + "\n")
    got = tio.load_note_events(str(path))
    want = jio.load_note_events(str(path))
    assert got.shape == want.shape == (len(events), 3)
    np.testing.assert_array_equal(got, want)
