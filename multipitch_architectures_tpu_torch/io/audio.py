"""Host-side audio and note-event loading (the reference's notebook-01
inputs).

Counterpart of ``multipitch_architectures_tpu/io/audio.py``: the same
functions and schemas, numpy and scipy on the host. The note-event
readers parse with the ``csv`` module and ``str.split`` instead of pandas
(the machine with the card has no pandas) and reproduce what the JAX
package takes from ``pandas.read_csv``:

- the first row names the columns (or, with ``header=False``, columns are
  numbered from 0);
- blank lines are skipped; a separator of ``None`` splits on runs of
  whitespace, leading and trailing whitespace ignored;
- a numeric column is parsed to float64, pandas' missing-value strings
  (and empty fields) to NaN; a column read without ``dtype`` keeps
  integers exact, and integer sample indices divided by ``source_fs``
  give the same float64 as pandas' int64 column divided by it.

Decimal fields parse alike as long as they carry at most 15 significant
digits; pandas' own float parser is not correctly rounded beyond that.
"""

import csv
import re
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np

_NOTE_RE = re.compile(r"^([A-Ga-g])([#b]?)(-?\d+)$")
_NOTE_BASE = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
# pandas.read_csv's default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}


def note_name_to_midi(name: str) -> float:
    """Scientific pitch notation → MIDI (C4 = 60); e.g. 'A4' → 69."""
    m = _NOTE_RE.match(name.strip())
    if not m:
        raise ValueError(f"unparseable note name {name!r}")
    letter, accidental, octave = m.groups()
    midi = (_NOTE_BASE[letter.upper()]
            + {"#": 1, "b": -1, "": 0}[accidental]
            + 12 * (int(octave) + 1))
    return float(midi)


@dataclass(frozen=True)
class NoteEventSchema:
    """Column map of a note-event annotation file: where onset, offset
    and pitch live and in which units, so that any corpus's text
    annotations feed :class:`..experiments.runner.AudioCorpus` without a
    loader of their own. Named presets for the Exp4 corpora are in
    :data:`NOTE_EVENT_SCHEMAS`.

    Fields name a column by header (str) or position (int). ``sep=None``
    means whitespace. ``time_unit``: 'seconds' | 'ms' | 'samples' (uses
    ``source_fs``). ``pitch_unit``: 'midi' | 'hz' (69+12·log2(f/440)) |
    'name' (scientific notation, 'A4'→69). ``f0_track=True`` reads
    (time, f0) FRAME rows instead of note events: consecutive voiced
    frames become per-frame events (offset = next frame time), which the
    nooverlap rasterizer merges back into contiguous rolls (the
    ChoralSingingDataset ships per-singer f0 tracks, not note events)."""

    sep: Optional[str] = ","
    onset: Union[str, int] = 0
    offset: Union[str, int] = 1
    pitch: Union[str, int] = 2
    time_unit: str = "seconds"
    source_fs: float = 44100.0
    pitch_unit: str = "midi"
    header: Optional[bool] = None     # None = sniff (non-numeric 1st row)
    f0_track: bool = False


#: Presets for the public text exports of the Exp4 corpora (the reference
#: precomputes every corpus to .npy pitch rolls, exp210d…py:160,631; these
#: cover the direct-from-audio path; override with a custom
#: NoteEventSchema if an export differs).
NOTE_EVENT_SCHEMAS = {
    # MusicNet csv: start_time/end_time as 44.1 kHz sample indices,
    # pitch in column 'note' (reference notebook 01, cell 7)
    "musicnet": NoteEventSchema(sep=",", onset="start_time",
                                offset="end_time", pitch="note",
                                time_unit="samples", source_fs=44100.0),
    # Schubert Winterreise ann_audio_note: semicolon csv, seconds
    "swd": NoteEventSchema(sep=";", onset="start", offset="end",
                           pitch="pitch"),
    # Bach10 note-event text export: whitespace 'onset offset midi',
    # times in MILLISECONDS (the dataset's GTNotes are 10 ms frames)
    "bach10": NoteEventSchema(sep=None, time_unit="ms"),
    # PHENICX-Anechoic score-aligned notes: 'onset,offset,notename'
    # in seconds (e.g. '0.917,1.476,A4')
    "phenicx": NoteEventSchema(sep=",", pitch_unit="name"),
    # ChoralSingingDataset per-singer f0 tracks: 'time_sec,f0_hz' frames
    "csd": NoteEventSchema(sep=",", onset=0, pitch=1, pitch_unit="hz",
                           f0_track=True),
}


def load_audio(path, fs: int = 22050) -> np.ndarray:
    """Mono float32 audio at ``fs``: ``.npy`` raw audio passthrough, or
    ``.wav`` via scipy (stereo averaged, ints normalized, polyphase
    resample on rate mismatch)."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    from scipy.io import wavfile

    rate, data = wavfile.read(path)
    # Normalize by the STORED dtype before any arithmetic: a stereo mean
    # would promote int16/uint8 samples to float64 and skip this branch.
    if data.dtype.kind == "i":
        data = data / np.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        # 8-bit WAVs are unsigned with a mid-scale zero (128 for uint8):
        # remove the DC offset, then scale to [-1, 1)
        half_range = (np.iinfo(data.dtype).max + 1) / 2.0
        data = (data.astype(np.float32) - half_range) / half_range
    elif data.dtype.kind != "f":
        raise ValueError(f"unsupported WAV sample format {data.dtype}")
    if data.ndim > 1:
        data = data.mean(axis=1)
    if rate != fs:
        from scipy.signal import resample_poly

        g = np.gcd(rate, fs)
        data = resample_poly(data, fs // g, rate // g)
    return np.asarray(data, np.float32)


class _Table:
    """A delimited text file's columns as lists of strings, read as
    ``pandas.read_csv`` reads it (see the module docstring)."""

    def __init__(self, path, sep: Optional[str], header: bool):
        # utf-8-sig: pandas drops a leading byte-order mark too
        with open(path, newline="", encoding="utf-8-sig") as f:
            if sep is None:
                rows = [line.split() for line in f]
            else:
                rows = list(csv.reader(f, delimiter=sep))
        # blank and whitespace-only lines are skipped; ',,' is a row of NaN
        rows = [r for r in rows if r and (len(r) > 1 or r[0].strip())]
        width = len(rows[0]) if rows else 0
        self.columns: List[Union[str, int]] = list(range(width))
        if header:
            if not rows:
                raise ValueError(f"{path}: no header row")
            self.columns, rows = rows[0], rows[1:]
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError(f"{path}: row {i} has {len(r)} fields, the "
                                 f"table {width}")
        self._rows = [r + [""] * (width - len(r)) for r in rows]

    def strings(self, key) -> List[str]:
        """The column named ``key`` (its header, or its number without
        one)."""
        if key not in self.columns:
            raise KeyError(key)
        j = self.columns.index(key)
        return [r[j] for r in self._rows]

    def numbers(self, key) -> np.ndarray:
        """The column as float64, missing values NaN."""
        return np.array([np.nan if v.strip() in _NA else float(v)
                         for v in self.strings(key)], dtype=np.float64)


def load_note_events(csv_path, source_fs: float = 44100.0,
                     schema: Union[None, str, NoteEventSchema] = None
                     ) -> np.ndarray:
    """Note-event file → (start_sec, end_sec, midi_pitch) float64 rows.

    With ``schema=None``, two public schemas are auto-detected (they
    feed the Exp1-3 corpora):

    - MusicNet: comma-separated, ``start_time``/``end_time`` as SAMPLE
      indices at 44.1 kHz, pitch in column ``note``
      (01 notebook cell 7: sample indices / 44100);
    - SWD / Schubert Winterreise ``ann_audio_note``: SEMICOLON-separated
      with ``start``/``end`` already in seconds and a ``pitch`` column
      (the Exp3 corpus; detected via the ';' header + column names).

    Any other corpus (Bach10, PHENICX-Anechoic, ChoralSingingDataset, or
    your own) passes ``schema=``: a :data:`NOTE_EVENT_SCHEMAS` preset
    name or a custom :class:`NoteEventSchema` column map.
    """
    if schema is not None:
        if isinstance(schema, str):
            schema = NOTE_EVENT_SCHEMAS[schema]
        return _load_note_events_schema(csv_path, schema)
    with open(csv_path) as f:
        header = f.readline()
    sep = ";" if header.count(";") > header.count(",") else ","
    table = _Table(csv_path, sep, header=True)
    names = table.columns
    cols = {c.lower().strip(): c for c in names}
    if "start" in cols and "end" in cols and "pitch" in cols:
        # SWD schema: seconds already
        start = table.numbers(cols["start"])
        end = table.numbers(cols["end"])
        pitch = table.numbers(cols["pitch"])
    else:
        start = table.numbers(cols.get("start_time", names[0])) / source_fs
        end = table.numbers(cols.get("end_time", names[1])) / source_fs
        pitch = table.numbers(cols.get("note", names[3]))
    return np.stack([start, end, pitch], axis=1)


def _load_note_events_schema(path, s: NoteEventSchema) -> np.ndarray:
    """Apply an explicit :class:`NoteEventSchema` column map."""
    by_name = (isinstance(s.onset, str) or isinstance(s.offset, str)
               or isinstance(s.pitch, str))
    header = s.header
    if header is None and not by_name:
        with open(path) as f:
            first = (f.readline().split(s.sep) if s.sep
                     else f.readline().split())
        try:
            float(first[0])
            header = False
        except (ValueError, IndexError):
            header = True
    table = _Table(path, s.sep, header=bool(by_name or header))

    def col(key):
        return key if isinstance(key, str) else table.columns[key]

    scale = {"seconds": 1.0, "ms": 1e-3,
             "samples": 1.0 / s.source_fs}[s.time_unit]
    onset = table.numbers(col(s.onset)) * scale

    if s.pitch_unit == "midi":
        pitch = table.numbers(col(s.pitch))
    elif s.pitch_unit == "hz":
        hz = table.numbers(col(s.pitch))
        with np.errstate(divide="ignore"):
            pitch = 69.0 + 12.0 * np.log2(np.maximum(hz, 1e-12) / 440.0)
        pitch = np.where(hz > 0, np.round(pitch), -1.0)
    elif s.pitch_unit == "name":
        pitch = np.array([note_name_to_midi(v)
                          for v in table.strings(col(s.pitch))])
    else:
        raise ValueError(f"unknown pitch_unit {s.pitch_unit!r}")

    if s.f0_track:
        # (time, f0) frame rows → one event per voiced frame; offset =
        # next frame time (last frame gets the median hop). The
        # nooverlap rasterizer merges adjacent same-pitch frames.
        if len(onset) == 0:
            return np.zeros((0, 3))
        hop = float(np.median(np.diff(onset))) if len(onset) > 1 else 0.01
        offset = np.concatenate([onset[1:], [onset[-1] + hop]])
        voiced = pitch >= 0
        return np.stack([onset[voiced], offset[voiced],
                         pitch[voiced]], axis=1)

    offset = table.numbers(col(s.offset)) * scale
    return np.stack([onset, offset, pitch], axis=1)
