"""The port's recorder: spans, counters and a whole-run trace.
Counterpart of the JAX package's ``utils/profiling.py``:

- :func:`span`: a named range around a piece of the port's work. It is a
  shared no-op unless :func:`recording` is on; then it is a
  ``torch.profiler.record_function`` range named ``mpa.<name>``, in the
  profiler's own time base, so that a profile can put the card's kernels
  and idle gaps down to it. Names nest by a dot: ``hcqt.tuning`` is a
  child of ``hcqt``;
- :func:`recording`: turns spans on for the enclosed block;
- :data:`counters`: integers that the port always counts (kernel
  launches, plan builds, the protocol's batches and windows); a reader
  takes their change over the stretch it measures;
- :func:`trace`: ``torch.profiler`` (CPU, and CUDA where there is a
  card) with spans on, written as a Chrome trace;
- :func:`device_sync`: waits for the card's queued work.
"""

import contextlib
import os

import torch

counters = {
    "k1.launches": 0,                 # CQT octave kernel launches
    "int8.mm_launches": 0,            # int8 GEMM kernel launches
    "int8.conv_launches": 0,
    "int8.conv_dequant_launches": 0,
    "hcqt.plan_builds": 0,            # CQT plans built (plan cache misses)
    "protocol.batches": 0,            # batches of the windowed protocol
    "protocol.windows": 0,            # windows in them
    "conv.dgrad_as_forward": 0,       # conv data gradients computed as
    #                                   forward convolutions (ops/conv.py)
    "conv.dgrad_fallback": 0,         # convs left on autograd's own path
}

_NULL = contextlib.nullcontext()
_recording = 0          # depth of the open recording() blocks


def span(name: str):
    """A context manager around the port's work ``name``: with
    :func:`recording` off, one shared null context (no profiler call, no
    clock read); on, the range ``mpa.<name>`` of ``torch.profiler``."""
    if not _recording:
        return _NULL
    return torch.profiler.record_function("mpa." + name)


@contextlib.contextmanager
def recording():
    """Spans are on inside the block (blocks may nest)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


@contextlib.contextmanager
def trace(log_dir: str, filename: str = "trace.json"):
    """Profile the enclosed block, the port's spans on: ``with
    trace('/tmp/prof') as prof: step()``. Writes ``<log_dir>/<filename>``
    (a Chrome trace, for ``chrome://tracing`` or Perfetto) and yields the
    profiler, whose ``events()`` and ``key_averages()`` the caller may
    read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording():
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
