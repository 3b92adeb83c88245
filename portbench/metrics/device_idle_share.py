"""1 - device busy / wall over the profiled window (serving) or steps
(training)."""

from portbench import reduce


def read(run):
    return reduce.idle_percent(run)
