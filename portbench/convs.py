"""cuDNN's convolution kernels in a training cell's profile, split into
its two families of algorithm by kernel name: the FFT convolutions and
every other (implicit-GEMM, direct and grouped-direct fprop, dgrad and
wgrad kernels). The readers ``fft_conv_ms_per_step`` and
``conv_ms_per_step`` report each family's device ms per profiled step."""

FFT = ("fft", "cf32")        # the transforms; the complex-float GEMMs
CONV = ("convolve", "conv2d", "fprop", "dgrad", "wgrad", "winograd",
        "cudnn::cnn::")


def family(name):
    """The family of a kernel name: "fft", "conv", or None where it is
    no convolution kernel."""
    low = name.lower()
    if any(m in low for m in FFT):
        return "fft"
    if any(m in low for m in CONV):
        return "conv"
    return None


def ms_per_step(run, which):
    """Device ms per profiled step in kernels of family ``which``; None
    where the run has no profile of training steps."""
    p = run.profile
    if p is None or not p["busy"]:
        return None
    steps = sum(1 for name, _, _ in p["spans"] if name == "step")
    if not steps:
        return None
    s = sum(v for k, v in p["kernels_s"].items() if family(k) == which)
    return 1e3 * s / steps
