"""Tracing and step timing. Counterpart of the JAX package's
``utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` (CPU, and
  CUDA where there is a card) that writes a Chrome trace;
- :func:`device_sync`: waits for the card's queued work;
- :class:`StepTimer`: wall-clock statistics per step, with the card
  synchronised, so that times measure finished work, not its enqueue.
"""

import contextlib
import os
import time
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, filename: str = "trace.json"):
    """Profile the enclosed block: ``with trace('/tmp/prof') as prof:
    step()``. Writes ``<log_dir>/<filename>`` (a Chrome trace, for
    ``chrome://tracing`` or Perfetto) and yields the profiler, whose
    ``events()`` and ``key_averages()`` the caller may read after the
    block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        device_sync()
    prof.export_chrome_trace(os.path.join(log_dir, filename))


def device_sync(value=None):
    """Wait until the card has finished its queued work: the device of
    ``value`` (a tensor) when given, else the current card. A no-op on
    the CPU and where CUDA was never initialised."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Collects per-step wall times (seconds). ``block=True`` synchronises
    the card at the end of each step (:func:`device_sync`)."""

    def __init__(self, block: bool = True):
        self.block = block
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.block:
            device_sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    def wrap(self, fn):
        """Wrap a step function: returns a timed version."""

        def timed(*a, **k):
            with self:
                return fn(*a, **k)

        return timed

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)

    def summary(self, warmup: int = 1):
        ts = self.times[warmup:] or self.times
        ts_sorted = sorted(ts)
        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "p50_s": ts_sorted[len(ts) // 2],
            "max_s": ts_sorted[-1],
        }
