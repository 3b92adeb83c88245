"""Note-event → binary piano-roll rasterization.

Counterpart of ``multipitch_architectures_tpu/dsp/annotation.py``: the
same host-side numpy, matching the reference semantics
(libdl/data_preprocessing/hcqt.py:167-272):

- ``compute_annotation_array_nooverlap`` — the variant every experiment
  uses: floors start/end to frame indices and repairs zero-length events by
  nudging boundaries so adjacent repeated notes never merge; end frame is
  EXCLUSIVE (hcqt.py:270).
- ``compute_annotation_array`` — ceil-start/floor-end variant with
  INCLUSIVE end. NB the reference function has no return statement
  (hcqt.py:202) and is therefore dead code there; ours returns the array.
"""

import numpy as np

_HEIGHTS = {"pitch_class": 12, "pitch": 128, "instruments": 1}


def _pitch_index(value, annot_type):
    if annot_type == "pitch_class":
        return int(value) % 12
    if annot_type == "pitch":
        return int(value)
    return 0  # instruments


def compute_annotation_array(note_events, n_frames, fs_hcqt,
                             annot_type="pitch_class"):
    """Simple rasterizer: ceil(start·fs), floor(end·fs), inclusive end;
    sub-frame events get their nearer boundary extended (hcqt.py:191-202)."""
    height = _HEIGHTS[annot_type]
    note_events = np.asarray(note_events, np.float64)
    out = np.zeros((height, n_frames))
    for start_sec, end_sec, pitch, *_ in note_events:
        start = int(np.ceil(start_sec * fs_hcqt))
        end = int(np.floor(end_sec * fs_hcqt))
        if end - start < 1:
            if abs(start - start_sec * fs_hcqt) < abs(end - end_sec * fs_hcqt):
                start -= 1
            else:
                end += 1
        assert end - start >= 0
        out[_pitch_index(pitch, annot_type), max(start, 0):end + 1] = 1
    return out


def compute_annotation_array_nooverlap(note_events, n_frames, fs_hcqt,
                                       annot_type="pitch_class", shorten=1.0):
    """The production rasterizer (hcqt.py:205-272). Semantics:

    1. optionally shorten each event to ``shorten`` of its duration;
    2. floor start/end seconds to frame indices (end exclusive);
    3. repair vanishing (duration < 1 frame) events: for every end frame
       shared by a vanishing event, push all events starting OR ending on
       that frame one frame later, then pull the vanishing events' starts
       one frame earlier (twice if still empty) — this keeps adjacent
       repeated notes separated instead of merging them.
    """
    height = _HEIGHTS[annot_type]
    ev = np.array(note_events, np.float64, copy=True)
    if ev.size == 0:
        return np.zeros((height, n_frames))
    if shorten != 1.0:
        ev[:, 1] = ev[:, 0] + shorten * (ev[:, 1] - ev[:, 0])

    frames = ev.copy()
    frames[:, :2] = np.floor(frames[:, :2] * fs_hcqt)

    durations = frames[:, 1] - frames[:, 0]
    vanishing = np.nonzero(durations < 1)[0]

    for end_frame in np.unique(frames[vanishing, 1]):
        frames[frames[:, 0] == end_frame, 0] += 1
        frames[frames[:, 1] == end_frame, 1] += 1
    frames[vanishing, 0] -= 1
    still = np.nonzero(frames[:, 1] - frames[:, 0] < 1)[0]
    frames[still, 0] -= 1
    assert np.all(frames[:, 1] - frames[:, 0] >= 1), \
        "still events of length<1 after correction!"

    out = np.zeros((height, n_frames))
    for row in frames:
        start, end = int(row[0]), int(row[1])
        out[_pitch_index(row[2], annot_type), max(start, 0):end] = 1
    return out
