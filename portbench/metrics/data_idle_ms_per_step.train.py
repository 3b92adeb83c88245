"""Device idle ms per profiled step while the host is inside the data
layer (each next() of the iterable that Trainer.fit consumes): the time
that the card waits for the pipeline."""

from portbench import reduce


def read(run):
    return reduce.idle_ms_per_span(run, "data")
