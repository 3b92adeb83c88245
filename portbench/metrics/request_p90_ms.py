"""90th percentile (nearest rank) over every request due in the window
of completion minus due time, failures infinite (host clock)."""

from portbench import reduce


def read(run):
    return reduce.percentile(reduce.latencies_ms(run), 90)
