"""1 - device busy / wall over the union of the requests' service
intervals in the profile: time between requests measures the offered
rate, not the port."""

from portbench import reduce


def read(run):
    return reduce.idle_percent(run, within="request")
