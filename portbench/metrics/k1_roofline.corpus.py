"""K1's share of its roofline over the window's HCQTs (profile)."""

from portbench import reduce


def read(run):
    return reduce.k1_roofline(run)
