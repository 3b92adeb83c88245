"""The kernels' variants tools on the CPU: every variant in their tables
still applies to the kernel's current source, and a missing text stops
the tool. (The variants themselves build and run only on a CUDA card.)"""

import pytest

from multipitch_architectures_tpu_torch.ops import (
    _build, _variants, cqt_octave_variants, int8_gemm_variants)

TABLES = [("cqt_octave", cqt_octave_variants.VARIANTS),
          ("int8_gemm", int8_gemm_variants.VARIANTS)]


@pytest.mark.parametrize("kernel,name", [(k, n) for k, t in TABLES
                                         for n in t])
def test_variant_applies_to_the_source(kernel, name):
    variants = dict(TABLES)[kernel]
    src = _variants.source(kernel, variants[name])
    for old, new in variants[name]:
        assert new in src
    # the final design is the source itself, and it keys the same library
    if not variants[name]:
        assert _build.library_path(kernel, src) == _build.library_path(kernel)


def test_missing_text_stops_the_tool():
    with pytest.raises(ValueError, match="not in the source"):
        _variants.source("cqt_octave", [("no such line;", "")])
