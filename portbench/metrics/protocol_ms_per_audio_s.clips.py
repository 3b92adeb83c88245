"""Host ms in predict_framewise, the output copied to the host, per
second of audio served."""

from portbench import reduce


def read(run):
    return reduce.span_ms_per_audio_s(run, "protocol")
