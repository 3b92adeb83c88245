"""The int8 GEMM's (K2/K3) share of its roofline over the window's int8
batches (profile)."""

from portbench import reduce


def read(run):
    return reduce.int8_gemm_roofline(run)
