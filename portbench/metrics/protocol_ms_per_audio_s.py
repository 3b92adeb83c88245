"""Host ms in the serving mode's entry (predict_framewise; in int8,
predict_framewise_int8 with its calibration pass and scales), the output
copied to the host, per second of audio served."""

from portbench import reduce


def read(run):
    return reduce.span_ms_per_audio_s(run, "protocol")
