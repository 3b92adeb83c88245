"""Host ms in compute_efficient_hcqt per second of audio served."""

from portbench import reduce


def read(run):
    return reduce.span_ms_per_audio_s(run, "frontend")
