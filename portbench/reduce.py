"""From a run's record (requests, spans, profile summary) to metrics.
The metric readers under ``portbench/metrics/`` call these; each returns
None where the run has nothing to read."""

import math

from . import common
from .common import FLOAT32_PEAK, PEAKS
from .counts import cqt, int8
from .serve import frames, served_batches


def done(run):
    return [r for r in run.requests if r["end"] is not None]


def audio_s(run):
    return sum(r["audio_s"] for r in done(run))


def windows(run):
    fe = run.cfg["frontend"]
    return sum(frames(r["audio_s"], fe) for r in done(run))


def span_ms_per_audio_s(run, name):
    """Host ms of the window's ``name`` spans per second of audio served."""
    ids = {i for i, r in enumerate(run.requests) if r["end"] is not None}
    ms = sum(t1 - t0 for n, t0, t1, i in run.spans
             if n == name and i in ids) * 1e3
    a = audio_s(run)
    return ms / a if a else None


def latencies_ms(run):
    """Completion minus due time of every request due in the window; a
    request that never completed counts as infinite."""
    return sorted(math.inf if r["end"] is None else
                  (r["end"] - r["due"]) * 1e3 for r in run.requests)


def percentile(values, q):
    """Nearest rank: the smallest value with ``q`` % of them at or below."""
    if not values:
        return None
    return values[max(0, math.ceil(q / 100 * len(values)) - 1)]


def serve_flops_per_window(run):
    """float32 FLOPs of one window, from the configuration's counts."""
    cfg = run.cfg
    g = cfg["serve"]["group"]
    return common.counts(cfg, run.root).forward_flops(
        cfg["model"]["args"], g, g, cfg["frontend"]["context"]) / g


def serve_flops(run):
    """The work of the window's finished requests as float32 FLOPs: the
    float32 calibration passes at the float32 rate, and every frame
    served after them by the serving mode (int8 operations weighed by
    the float32 peak over the int8 one)."""
    fe = run.cfg["frontend"]
    cal = served = 0
    for r in done(run):
        t = frames(r["audio_s"], fe)
        computed, reused = run.mode.cal(t)
        cal += computed
        served += t - reused
    flops = serve_flops_per_window(run)
    return flops * cal + run.mode.window_flops(run, flops) * served


def mfu_percent(flops, seconds):
    return 100.0 * flops / seconds / FLOAT32_PEAK if seconds else None


def k1_roofline(run):
    """K1's least time for the window's HCQTs (operations at the float32
    peak, or bytes at HBM's rate, whichever is longer) over its device
    time in the profile, in %."""
    p = run.profile
    if p is None:
        return None
    t = sum(v for k, v in p["kernels_s"].items() if "cqt_octaves" in k)
    if not t:
        return None
    fe = run.cfg["frontend"]
    bound = 0.0
    for r in done(run):
        flops, nbytes = cqt.hcqt_cost(fe, int(round(r["audio_s"] * fe["fs"])))
        bound += max(flops / FLOAT32_PEAK, nbytes / PEAKS["hbm_bytes_per_s"])
    return 100.0 * bound / t


def int8_gemm_roofline(run):
    """The int8 GEMM's least time for the window's int8 batches (each
    launch's operations at the int8 peak, or its bytes at HBM's rate,
    whichever is longer) over its device time in the profile, in %."""
    p = run.profile
    if p is None:
        return None
    t = sum(v for k, v in p["kernels_s"].items() if "int8_gemm_kernel" in k)
    if not t:
        return None
    costs = int8.convs(run.cfg, run.root)
    return 100.0 * sum(int8.least_seconds(costs, b)
                       for b in served_batches(run)) / t


def idle_percent(run, within=None):
    """Device idle share of the profiled stretch, or of the union of the
    profile's ``within`` spans."""
    p = run.profile
    if p is None or not p["busy"]:
        return None
    if within is None:
        return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
    from .trace import merge, overlap

    spans = merge((s, e) for n, s, e in p["spans"] if n == within)
    total = sum(e - s for s, e in spans)
    if not total:
        return None
    starts = [s for s, _ in p["busy"]]
    busy = sum(overlap(p["busy"], starts, s, e) for s, e in spans)
    return 100.0 * (1.0 - busy / total)


def idle_ms_per_span(run, name):
    """Device idle ms inside the profile's ``name`` spans, per span."""
    p = run.profile
    if p is None or not p["busy"]:
        return None
    from .trace import overlap

    spans = [(s, e) for n, s, e in p["spans"] if n == name]
    if not spans:
        return None
    starts = [s for s, _ in p["busy"]]
    idle = sum((e - s) - overlap(p["busy"], starts, s, e) for s, e in spans)
    return 1e3 * idle / len(spans)
