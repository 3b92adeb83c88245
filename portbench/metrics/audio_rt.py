"""Seconds of audio of every request completed over the wall time
from the window's start to the end of the last one (host clock)."""

from portbench import reduce


def read(run):
    return reduce.audio_s(run) / run.window_end
