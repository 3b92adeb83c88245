"""The port's recorder (``utils/profiling.py``) on the CPU: spans are a
shared no-op until ``recording()`` turns them into ``mpa.*`` ranges of
``torch.profiler``; the counters count where the work happens."""

import json

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from multipitch_architectures_tpu_torch.data import (AugmentConfig,
                                                     FileSpec, TrainPipeline)
from multipitch_architectures_tpu_torch.dsp import compute_efficient_hcqt
from multipitch_architectures_tpu_torch.eval import predict_framewise
from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer
from multipitch_architectures_tpu_torch.utils import (counters, profiling,
                                                      recording, span, trace)


def ranges(prof):
    """(name without ``mpa.``, start ns, end ns) of the profile's spans,
    in order of start."""
    out = [(e.name()[4:], e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("mpa.")]
    return sorted(out, key=lambda r: r[1])


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_is_a_shared_null_context_when_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("span called the profiler with recording off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("hcqt") as a, span("hcqt.tuning") as b:
            torch.ones(4).sum()
    assert span("a") is span("b") is profiling._NULL
    assert a is None and b is None
    assert ranges(prof) == []


def test_recorded_spans_nest_as_mpa_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        with span("outer"):
            with span("outer.inner"):
                torch.ones(4).sum()
            with recording(), span("outer.second"):
                pass
    (outer, inner, second) = ranges(prof)
    assert [r[0] for r in (outer, inner, second)] == [
        "outer", "outer.inner", "outer.second"]
    assert inside(inner, outer) and inside(second, outer)
    assert inner[2] <= second[1]
    assert span("after") is profiling._NULL


def test_plan_builds_count_cache_misses_only():
    """Three plans (the HCQT's bases 0.5, 3 and 5) at a tuning not seen
    before, none when it repeats."""
    y = np.random.RandomState(0).randn(5512).astype(np.float32)
    kw = dict(fs_hcqt_target=50, bins_per_octave=12, num_octaves=2,
              tuning=0.3721, device="cpu")
    before = counters["hcqt.plan_builds"]
    compute_efficient_hcqt(y, **kw)
    assert counters["hcqt.plan_builds"] - before == 3
    compute_efficient_hcqt(y, **kw)
    assert counters["hcqt.plan_builds"] - before == 3


class _Mean(nn.Module):
    """(B, C, 75, F) windows -> (B, 1, 1, 2)."""

    def forward(self, x):
        return x.mean(dim=(1, 2, 3)).reshape(-1, 1, 1, 1).expand(-1, 1, 1, 2)


def test_protocol_counts_batches_and_windows():
    """300 frames at batch 250 and group 50: a full batch and a tail of
    50, each a ``protocol.batch`` inside ``protocol``."""
    x = torch.rand(2, 300, 4)
    before = {k: counters[k] for k in ("protocol.batches",
                                       "protocol.windows")}
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        out = predict_framewise(_Mean().eval(), x, batch_size=250, group=50)
    assert out.shape == (300, 2)
    assert counters["protocol.batches"] - before["protocol.batches"] == 2
    assert counters["protocol.windows"] - before["protocol.windows"] == 300
    top, *batches = ranges(prof)
    assert top[0] == "protocol"
    assert [b[0] for b in batches] == ["protocol.batch"] * 2
    assert all(inside(b, top) for b in batches)


class _Toy(nn.Sequential):
    def __init__(self):
        super().__init__(nn.Conv2d(6, 2, (75, 3), stride=(1, 3)),
                         nn.BatchNorm2d(2), nn.ReLU(), nn.Conv2d(2, 1, 1),
                         nn.Sigmoid())


def test_train_step_and_pipeline_spans_nest_in_order():
    """One ``Trainer.train_step``: forward, backward and optimizer inside
    ``step``, in that order; the pipeline's batch holds its gather and
    augmentation."""
    rng = np.random.RandomState(0)
    files = [FileSpec(rng.rand(6, 200, 216).astype(np.float32),
                      (rng.rand(200, 120) > 0.9).astype(np.float32))]
    pipe = TrainPipeline(files, stride=25,
                         augment=AugmentConfig(transposition=5, noisestd=1e-4),
                         target_slice=(24, 96), device="cpu")
    trainer = Trainer(_Toy(), TrainConfig(batch_size=2),
                      device="cpu").init(seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        x, y = next(iter(pipe.batches(3, 2)))
        trainer.train_step(x, y)
    got = ranges(prof)
    assert [r[0] for r in got] == [
        "data.batch", "data.gather", "data.augment",
        "step", "step.forward", "step.backward", "step.optimizer"]
    batch, gather, augment, step, *parts = got
    assert inside(gather, batch) and inside(augment, batch)
    assert all(inside(p, step) for p in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))


def test_trace_writes_the_ports_spans(tmp_path):
    with trace(str(tmp_path)):
        with span("hcqt"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert "mpa.hcqt" in names
    assert span("hcqt") is profiling._NULL


@pytest.mark.parametrize("on", [False, True])
def test_span_balances_recording_after_an_error(on):
    """A raise inside a span or a recording block leaves spans as they
    were before it."""
    with pytest.raises(ValueError):
        with (recording() if on else profiling._NULL), span("x"):
            raise ValueError
    assert span("x") is profiling._NULL
