"""1 - device busy / wall over the profiled window."""

from portbench import reduce


def read(run):
    return reduce.idle_percent(run)
