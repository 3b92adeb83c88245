"""Device ms per profiled training step in cuDNN's FFT convolutions: the
transforms (kernel names with ``fft``) and the complex-float GEMMs
(``cf32``) that multiply in the frequency domain (profile)."""

from portbench import convs


def read(run):
    return convs.ms_per_step(run, "fft")
