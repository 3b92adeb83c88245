"""Device ms per profiled training step in every convolution kernel that
is not an FFT's: implicit-GEMM, direct and grouped-direct fprop, dgrad
and wgrad (profile)."""

from portbench import convs


def read(run):
    return convs.ms_per_step(run, "conv")
