"""The one traffic generator: a mix's parameters and the run's seed in,
the requests' sizes and due times out.

Every seed gets the same multiset of sizes and gaps (the quantiles at
(i + 1/2)/n of their laws), in an order drawn from the seed, so seeds
change the order and the content of the work, not its amount. A mix
that names a ``schedule_seed`` draws that order from it instead: every
run then replays one schedule (sizes and due times), and the run's seed
changes only the content (audio, weights). An open loop's tail latency
needs it: with the order drawn anew, coincidences of long requests and
short gaps move a p90 of ~120 requests by 25-35 % between seeds.

Laws (``{"law": ..., ...}``): ``log_uniform`` (``low``, ``high``),
``exponential`` (``mean``).
"""

import numpy as np

from .common import stream


def quantiles(law, n):
    """The law's quantiles at (i + 1/2)/n, i < n, ascending."""
    u = (np.arange(n) + 0.5) / n
    kind = law["law"]
    if kind == "log_uniform":
        lo, hi = np.log(law["low"]), np.log(law["high"])
        return np.exp(lo + u * (hi - lo))
    if kind == "exponential":
        return -law["mean"] * np.log1p(-u)
    raise ValueError(f"unknown law {kind!r}")


def draw(law, n, rng):
    """``n`` values of ``law``: its quantiles in an order drawn from
    ``rng``."""
    return rng.permutation(quantiles(law, n))


def requests(mix, seed, seconds):
    """[(length in s, due time in s from the window's start)].

    A closed loop (``"loop": "closed"``) sends the ``pool`` requests one
    after the other, again from the first when the pool is spent: due
    times are None. An open loop (``"loop": "open"``) sends
    ``rate_per_s · seconds`` requests due inside the window, the gaps
    between them drawn from ``arrivals`` (``"poisson"``: exponential with
    mean 1/rate), scaled so that they fill the window exactly."""
    rng = stream(mix.get("schedule_seed", seed), 2)
    if mix["loop"] == "closed":
        lengths = draw(mix["length_s"], int(mix["pool"]), rng)
        return [(float(x), None) for x in lengths]
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    lengths = draw(mix["length_s"], n, rng)
    if mix["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    gaps = draw({"law": "exponential", "mean": 1.0}, n, rng)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    due *= seconds / gaps.sum()
    return [(float(x), float(t)) for x, t in zip(lengths, due)]
