"""The port's spans in a profile: ``program_trace`` over synthetic raw
events, and the harness's own summary unchanged by them; then a tiny
traced run of each kind on the CPU with the port's recording on."""

import pytest
import torch

from portbench import trace
from portbench.program_trace import (
    READINGS, innermost, program_summary, program_tracer)
from portbench.run import run_cell

MS = 1e-3


class Event:
    """What ``summarize`` and ``program_summary`` read of a raw profiler
    event; times in ms."""

    def __init__(self, name, t0, t1, cuda=False, corr=0, annotation=False):
        self._name, self.t0, self.t1 = name, t0, t1
        self.cuda, self.corr, self.annotation = cuda, corr, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return round(self.t0 * 1e6)

    def duration_ns(self):
        return round((self.t1 - self.t0) * 1e6)

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.cuda
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self.annotation

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        # a kernel's link is the id of the operator that launched it
        return self.corr + 1000 if self.cuda else 0


def launch(corr, t):
    return Event("cudaLaunchKernel", t, t + 0.01, corr=corr)


def kernel(corr, t0, t1):
    return Event(f"kernel{corr}", t0, t1, cuda=True, corr=corr)


HARNESS = [Event("portbench.data", 0, 10, annotation=True),
           Event("aten::mm", 11.5, 12, corr=999)]
PORT = [Event(f"mpa.{n}", t0, t1, annotation=True) for n, t0, t1 in [
    ("data.batch", 1, 9), ("data.gather", 1, 4), ("data.augment", 4, 9),
    ("step", 11, 30), ("step.forward", 11, 15), ("step.backward", 15, 25),
    ("step.optimizer", 25, 30)]] + [
    Event("mpa.step.backward", 17, 22, cuda=True, annotation=True)]
# (correlation, launch ms or None, device start, end): 101 is launched
# by another thread while the main one waits inside step.backward
KERNELS = [(102, 2, 3, 3.5), (103, 5, 6, 8), (105, 10.5, 10.6, 10.8),
           (101, 16, 17, 22), (104, 26, 27, 28), (999, None, 29, 29.5)]
WORK = [kernel(c, d0, d1) for c, _, d0, d1 in KERNELS] + [
    launch(c, t) for c, t, _, _ in KERNELS if t is not None]


def test_kernels_and_gaps_go_to_the_innermost_port_span():
    p = program_summary(HARNESS + PORT + WORK,
                        trace.summarize(HARNESS + PORT + WORK, 1.0)["busy"])
    dev = {k: round(v / MS, 6) for k, v in p["device_s_by_span"].items()}
    assert dev == {"data.gather": 0.5, "data.augment": 2.0, "no span": 0.2,
                   "step.backward": 5.0, "step.optimizer": 1.0,
                   "no launch": 0.5}
    assert p["launch_matched_share"] == pytest.approx(8.7 / 9.2)
    gaps = {k: round(v / MS, 6) for k, v in p["idle_gaps"]}
    assert gaps == {"data.augment": 2.5, "data": 2.6, "step.forward": 6.2,
                    "step.backward": 5.0, "step.optimizer": 1.0}
    assert p["spans"]["step"] == 1
    assert p["host_s_by_span"]["step.backward"] == pytest.approx(10 * MS)
    calls = {(c[0], c[1]): c[2] for c in p["runtime_calls"]}
    assert calls == {("data.gather", "cudaLaunchKernel"): 1,
                     ("data.augment", "cudaLaunchKernel"): 1,
                     ("no span", "cudaLaunchKernel"): 1,
                     ("step.backward", "cudaLaunchKernel"): 1,
                     ("step.optimizer", "cudaLaunchKernel"): 1}


def test_the_harness_summary_is_the_same_with_the_port_spans():
    with_port = trace.summarize(HARNESS + PORT + WORK, 1.0)
    without = trace.summarize(HARNESS + WORK, 1.0)
    for key in ("busy", "busy_s", "kernels_s", "device_ops", "spans",
                "idle_gaps"):
        assert with_port[key] == without[key], key


def test_innermost_takes_the_shortest_holder():
    spans = [("a", 0, 10), ("a.b", 2, 5), ("c", 4, 6)]
    assert innermost(spans, [1, 3, 4.5, 8, 11, None]) == [
        "a", "a.b", "c", "a", None, None]


@pytest.mark.parametrize("cell", ["exp180e-f32.clips", "exp180d-f32.train"])
def test_a_tiny_traced_run_reads_the_port_spans(tiny_root, cell):
    """On the CPU: host spans and counters; no device time to credit."""
    with program_tracer():
        result, run = run_cell(cell, 3, 2.0, 1, root=tiny_root,
                               require_card=False)
    assert result["correct"], result["checks"]
    assert trace.Tracer is not type(run.tracer)
    p, c = run.tracer.program, run.tracer.counters
    got = {f.__name__: f(run) for f in READINGS[run.mix["kind"]]}
    if run.mix["kind"] == "serve":
        done = sum(r["end"] is not None for r in run.requests)
        assert p["spans"]["hcqt"] == p["spans"]["hcqt.tuning"] == done
        assert p["spans"]["protocol.batch"] == c["protocol.batches"] > 0
        assert got["tuning_ms_per_audio_s"] > 0
        assert 0 <= got["plan_builds_per_request"] <= 3
        assert 0 < got["windows_per_batch"] <= 10
    else:
        # the profile holds whole steps, each fed by one batch
        assert p["spans"]["step"] == p["spans"]["data.batch"] \
            == p["spans"]["step.backward"] >= 1
        assert got == {"backward_device_ms_per_step": None,
                       "data_device_ms_per_step": None}
