"""1 - device busy / wall over the profiled steps."""

from portbench import reduce


def read(run):
    return reduce.idle_percent(run)
