"""Spans, and the profiler held to the measured window, reduced to a
summary in memory: device busy time, time by kernel name, and the idle
gaps by the harness span that the host was in.

Spans are recorded from the benchmark's own files, around its calls
into each layer of the program: always on the host clock, and, in a
traced run, as ``torch.profiler.record_function`` ranges named
``portbench.<layer>`` in the profile's time base.
"""

import bisect
import contextlib
import time

import torch

TOP = 10
DEPTH = 4           # harness spans nest at most this deep
NAME = 120         # characters of a kernel's name kept in the breakdown


class Tracer:
    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []               # (name, start s, end s, request)
        self.prof = None
        self.summary = None

    @contextlib.contextmanager
    def span(self, name, request=None):
        rf = (torch.profiler.record_function(f"portbench.{name}")
              if self.prof is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.append((name, t0, time.perf_counter(), request))

    def start(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()

    def stop(self):
        if self.prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.done, self.prof = self.prof, None

    def reduce(self):
        """The summary of the stopped profile; called once the window has
        closed, so that no reading of the trace falls inside it."""
        if getattr(self, "done", None) is not None:
            self.summary = summarize(
                self.done.profiler.kineto_results.events(), self.window_s)
            self.done = None


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(busy, starts, lo, hi):
    """Length of the merged intervals ``busy`` (their ``starts``) inside
    [lo, hi]."""
    k = max(0, bisect.bisect_right(starts, lo) - 1)
    total = 0.0
    while k < len(busy) and busy[k][0] < hi:
        total += max(0.0, min(busy[k][1], hi) - max(busy[k][0], lo))
        k += 1
    return total


def summarize(events, window_s):
    """The profile of the window from the profiler's raw events: device
    intervals (s) merged, busy s, s by kernel name, the harness spans,
    and the idle gaps between device operations by the innermost harness
    span that the host was in."""
    dev, spans = [], []
    for e in events:
        name = e.name()
        t0 = e.start_ns() / 1e9
        t1 = t0 + e.duration_ns() / 1e9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the harness spans' device-side annotations are no work
            if not (e.is_user_annotation() or name.startswith("portbench.")):
                dev.append((t0, t1, name))
        elif name.startswith("portbench."):
            spans.append((t0, t1, name[len("portbench."):]))
    busy = merge((s, e) for s, e, _ in dev)
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    spans.sort()
    starts = [s for s, _, _ in spans]
    gaps = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        k = bisect.bisect_right(starts, mid)
        inside = [sp for sp in spans[max(0, k - DEPTH):k] if sp[1] >= mid]
        name = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside \
            else "no span"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0)
    return {
        "busy": busy,
        "busy_s": sum(e - s for s, e in busy),
        "window_s": window_s,
        "kernels_s": by_name,
        "spans": [(n, s, e) for s, e, n in spans],
        "device_ops": sorted(([k[:NAME], v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }
