"""The port's own spans and counters in a traced run of one cell.

    python -m portbench.program_trace --workload <cell> --seed <n> \\
        --seconds <s>

Runs the cell as ``python -m portbench ... --trace 1`` does, with the
port's recording (``multipitch_architectures_tpu_torch.utils.recording``)
on over the profiled stretch, and prints the harness's result line with
two keys more: ``end_to_end``, the cell's end-to-end metrics, which a
traced run of the harness does not print, and ``program``:

- ``readings``: the layer readings below (:data:`READINGS`);
- ``counters``: the port's counters' change over the profiled stretch;
- ``device_s_by_span``: kernel device seconds by the innermost ``mpa.*``
  span whose host interval holds the kernel's launch, on any thread
  (``loss.backward()`` launches from the autograd engine's thread while
  the main thread waits inside ``step.backward``);
- ``host_s_by_span`` and ``spans``: host seconds and count of each span;
- ``runtime_calls``: the CUDA API calls (launches, copies,
  synchronisations) by the innermost span that made them, with
  their count and host seconds: where the host waits on the card;
- ``idle_gaps``: the card's idle gaps by the innermost span, of the port
  or of the harness, that the host was in at the gap's middle.

The harness's ``Tracer`` neither turns the port's recording on nor keeps
the profile's raw events. ``Run`` builds its tracer from
``portbench.trace.Tracer`` when it is created, so this tool puts a
subclass there for its one run. With recording off, the harness's own
traced runs carry no ``mpa.*`` range.
"""

import time

START = time.perf_counter()     # before torch and the port are imported

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

import torch  # noqa: E402

from . import reduce, trace  # noqa: E402

PORT = "mpa."
HARNESS = "portbench."
RUNTIME = "cu"      # the CPU-side events of CUDA API calls:
#                     cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...


class ProgramTracer(trace.Tracer):
    """The harness's tracer with the port's recording on while the
    profiler runs, the counters read at both ends, and the raw events
    reduced once more by :func:`program_summary`."""

    def __init__(self, on, device):
        super().__init__(on, device)
        self.recording = None
        self.counters = self.program = None

    def start(self):
        from multipitch_architectures_tpu_torch.utils import (counters,
                                                              recording)

        super().start()
        if self.prof is not None and self.recording is None:
            self.recording = recording()
            self.recording.__enter__()
            self.before = dict(counters)

    def stop(self):
        from multipitch_architectures_tpu_torch.utils import counters

        if self.prof is None:
            return
        super().stop()
        self.recording.__exit__(None, None, None)
        self.counters = {k: v - self.before[k] for k, v in counters.items()}

    def reduce(self):
        if getattr(self, "done", None) is None:
            return
        events = self.done.profiler.kineto_results.events()
        self.summary = trace.summarize(events, self.window_s)
        self.program = program_summary(events, self.summary["busy"])
        self.done = None


@contextlib.contextmanager
def program_tracer():
    """Runs built inside the block record the port's spans."""
    harness = trace.Tracer
    trace.Tracer = ProgramTracer
    try:
        yield
    finally:
        trace.Tracer = harness


def innermost(spans, times):
    """For each time (None: no time), the name of the shortest of
    ``spans`` (name, start, end) that holds it, or None."""
    spans = sorted(spans, key=lambda s: s[1])
    out = [None] * len(times)
    active, k = [], 0
    for i in sorted((i for i, t in enumerate(times) if t is not None),
                    key=times.__getitem__):
        t = times[i]
        while k < len(spans) and spans[k][1] <= t:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s[2] >= t]
        if active:
            out[i] = min(active, key=lambda s: s[2] - s[1])[0]
    return out


def program_summary(events, busy):
    """The port's spans in the profiler's raw ``events``; ``busy`` are
    the merged device intervals that ``trace.summarize`` found."""
    port, harness, launch, kernels, calls = [], [], {}, [], []
    for e in events:
        name = e.name()
        t0 = e.start_ns() / 1e9
        t1 = t0 + e.duration_ns() / 1e9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the spans' device-side annotations are no work
            if not (e.is_user_annotation()
                    or name.startswith((PORT, HARNESS))):
                # its runtime call's id; ``linked_correlation_id`` is
                # the id of the operator that made the call
                kernels.append((e.correlation_id(), t1 - t0))
        elif name.startswith(PORT):
            port.append((name[len(PORT):], t0, t1))
        elif name.startswith(HARNESS):
            harness.append((name[len(HARNESS):], t0, t1))
        elif name.startswith(RUNTIME) and "::" not in name:
            launch[e.correlation_id()] = t0
            calls.append((name, t0, t1))
    owners = innermost(port, [launch.get(c) for c, _ in kernels])
    device, matched = {}, 0.0
    for (c, d), owner in zip(kernels, owners):
        key = owner or ("no span" if c in launch else "no launch")
        device[key] = device.get(key, 0.0) + d
        matched += d if c in launch else 0.0
    by_call = {}
    for (name, t0, t1), owner in zip(calls, innermost(
            port, [t0 for _, t0, _ in calls])):
        n, sec = by_call.get((owner, name), (0, 0.0))
        by_call[owner, name] = (n + 1, sec + (t1 - t0))
    host, count = {}, {}
    for name, t0, t1 in port:
        host[name] = host.get(name, 0.0) + (t1 - t0)
        count[name] = count.get(name, 0) + 1
    mids = [(e0 + s1) / 2 for (_, e0), (s1, _) in zip(busy, busy[1:])]
    gaps = {}
    for ((_, e0), (s1, _)), owner in zip(zip(busy, busy[1:]),
                                         innermost(port + harness, mids)):
        key = owner or "no span"
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0)
    total = sum(d for _, d in kernels)
    return {
        "device_s_by_span": device,
        "launch_matched_share": matched / total if total else None,
        "host_s_by_span": host,
        "spans": count,
        "runtime_calls": sorted(([k[0] or "no span", k[1], n, sec]
                                 for k, (n, sec) in by_call.items()),
                                key=lambda c: -c[3])[:trace.TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:trace.TOP],
    }


def tuning_ms_per_audio_s(run):
    """Host ms in the port's ``hcqt.tuning`` spans per second of audio
    served."""
    p, a = run.tracer.program, reduce.audio_s(run)
    if p is None or "hcqt" not in p["spans"] or not a:
        return None
    return 1e3 * p["host_s_by_span"].get("hcqt.tuning", 0.0) / a


def plan_builds_per_request(run):
    """HCQT plans built (plan cache misses) per request completed."""
    n = len(reduce.done(run))
    if run.tracer.counters is None or not n:
        return None
    return run.tracer.counters["hcqt.plan_builds"] / n


def windows_per_batch(run):
    c = run.tracer.counters
    if c is None or not c["protocol.batches"]:
        return None
    return c["protocol.windows"] / c["protocol.batches"]


def _device_ms_per_step(run, keep):
    p = run.tracer.program
    if p is None or not p["spans"].get("step") \
            or not p["device_s_by_span"]:
        return None
    s = sum(v for k, v in p["device_s_by_span"].items() if keep(k))
    return 1e3 * s / p["spans"]["step"]


def backward_device_ms_per_step(run):
    """Kernel device ms launched inside ``step.backward`` per step."""
    return _device_ms_per_step(run, lambda k: k == "step.backward")


def data_device_ms_per_step(run):
    """Kernel device ms launched inside the pipeline's ``data.batch`` and
    its children per step."""
    return _device_ms_per_step(run, lambda k: k.split(".")[0] == "data")


READINGS = {
    "serve": [tuning_ms_per_audio_s, plan_builds_per_request,
              windows_per_batch],
    "train": [backward_device_ms_per_step, data_device_ms_per_step],
}


def span_cost_ns(calls=200_000):
    """Host ns per ``with span(...)``: recording off, then on (no
    profiler running)."""
    from multipitch_architectures_tpu_torch.utils import recording, span

    def per_call(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("hcqt.k1"):
                pass
        return (time.perf_counter() - t0) / n * 1e9

    off = per_call(calls)
    with recording():
        on = per_call(calls // 10)
    return {"off": off, "on": on}


def main(argv=None, start=None):
    from .common import benchmark, metric_reader
    from .run import metrics_of, run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    with program_tracer():
        result, run = run_cell(args.workload, args.seed, args.seconds, 1,
                               start=start)
    program = dict(run.tracer.program or {})
    program["readings"] = {f.__name__: f(run)
                           for f in READINGS[run.mix["kind"]]}
    program["counters"] = run.tracer.counters
    program["span_ns"] = span_cost_ns()
    result["end_to_end"] = {
        m["name"]: metric_reader(m["name"])(run)
        for m in metrics_of(benchmark(), run.cell, False)}
    result["program"] = program
    print(json.dumps(result, default=lambda x: None if isinstance(
        x, float) and math.isinf(x) else str(x)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(start=START))
