"""DSP feature frontend: constant-Q transform on the CQT octave kernel,
harmonic CQT, tuning estimation and annotation rasterization.

Counterpart of ``multipitch_architectures_tpu/dsp``, with the same
``__all__``. The CQT and HCQT run on the device (each octave through the
kernel on the card, through its plain version on the CPU); the tuning
estimate and the rasterizers are host numpy, as in the JAX package.
"""

from .hcqt import (
    compute_hopsize_cqt,
    compute_hcqt,
    compute_efficient_hcqt,
    efficient_hcqt_device,
    hcqt,
)
from .cqt import cqt, cqt_streamed, CqtPlan, cqt_direct_numpy
from .tuning import estimate_tuning
from .annotation import (
    compute_annotation_array,
    compute_annotation_array_nooverlap,
)

__all__ = [
    "compute_hopsize_cqt",
    "compute_hcqt",
    "compute_efficient_hcqt",
    "efficient_hcqt_device",
    "hcqt",
    "cqt",
    "cqt_streamed",
    "CqtPlan",
    "cqt_direct_numpy",
    "estimate_tuning",
    "compute_annotation_array",
    "compute_annotation_array_nooverlap",
]
