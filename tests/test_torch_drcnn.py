"""DCNN and DRCNN (``deep_cnn_segm_sigmoid``) held to the benchmark's plain
reference (``portbench/reference/drcnn.py``) on the CPU at tiny widths in
float64, with weights from ``portbench.weights.draw``: the forward, one
``Trainer.train_step`` against the reference's step, the counts, the
parameter names, the port's spans, and the readers of the two
convolution-family metrics."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multipitch_architectures_tpu_torch.experiments.configs import \
    build_model
from multipitch_architectures_tpu_torch.train.trainer import (TrainConfig,
                                                              Trainer)
from multipitch_architectures_tpu_torch.utils import profiling, recording
from portbench import common, convs, weights
from portbench.counts import drcnn as counts
from portbench.reference import drcnn, train as ref_train

ROOT = common.ROOT
CLASS = "deep_cnn_segm_sigmoid"
TINY = {"a_lrelu": 0.3, "n_bins_in": 36, "n_bins_out": 12,
        "n_chan_input": 6, "n_chan_layers": [8, 8, 6, 4],
        "n_prefilt_layers": 3, "p_dropout": 0.2}
SEED = 2 ** 31 + 1905
PUBLISHED = common.load_json(os.path.join(
    ROOT, "portbench", "configs", "exp128c-f32.json"))


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pair(residual, law="lecun_normal"):
    """The port's model and the reference, float64, one set of weights."""
    cfg = {"class": CLASS, "args": {**TINY, "residual": residual}}
    ref = drcnn.build(cfg)
    sd = weights.draw(ref, SEED, "cpu", law)
    ref.load_state_dict(sd, strict=True)
    port = build_model(CLASS, cfg["args"])
    port.load_state_dict(sd, strict=True)
    return port.double(), ref.double()


def window(batch=3, frames=75, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(batch, 6, frames, TINY["n_bins_in"], generator=g,
                   dtype=torch.float64)
    y = (torch.rand(batch, 1, frames - 74, TINY["n_bins_out"], generator=g)
         > 0.8).double()
    return x, y


def rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("law", ["lecun_normal", "he_uniform"])
def test_forward_equals_the_reference(residual, law):
    port, ref = pair(residual, law)
    port.eval(), ref.eval()
    for frames in (75, 90):
        x, _ = window(frames=frames)
        with torch.no_grad():
            out, want = port(x), ref(x)
        assert out.shape == want.shape == (3, 1, frames - 74, 12)
        assert rel(out, want) <= 1e-12


@pytest.mark.parametrize("residual", [True, False])
def test_train_step_equals_the_reference_step(residual):
    port, ref = pair(residual)
    t = PUBLISHED["train"]
    opt = dict(lr=t["initial_lr"], betas=tuple(t["betas"]), eps=t["eps"],
               weight_decay=t["weight_decay"])
    trainer = Trainer(port, TrainConfig(
        batch_size=3, initial_lr=opt["lr"], betas=opt["betas"],
        eps=opt["eps"], weight_decay=opt["weight_decay"],
        deterministic=True), device="cpu")
    x, y = window()
    step_seed = 1234
    torch.manual_seed(step_seed)
    loss = float(trainer.train_step(x, y))

    params = dict(ref.named_parameters())
    adamw = ref_train.AdamW(params, opt)
    losses, grads = ref_train.steps(ref, [(x, y)], [step_seed], adamw)
    assert abs(loss - losses[0]) <= 1e-12 * abs(losses[0])
    port_params = dict(port.named_parameters())
    assert set(port_params) == set(params)
    for k, p in port_params.items():
        g = grads[0][k]
        assert float((p.grad - g).abs().max()) <= \
            1e-10 * max(float(g.abs().max()), 1e-30), k
        assert rel(p.detach(), params[k].detach()) <= 1e-12, k


@pytest.mark.parametrize("residual", [True, False])
def test_state_dict_keys_are_the_same_both_ways(residual):
    port, ref = pair(residual)
    assert list(port.state_dict()) == list(ref.state_dict())
    port.load_state_dict(ref.state_dict(), strict=True)
    ref.load_state_dict(port.state_dict(), strict=True)
    assert {k.split(".")[0] for k in ref.state_dict()} == {
        "layernorm", "conv1", "prefilt_list", "conv2", "conv3", "conv4"}
    assert "conv4.3.weight" in ref.state_dict()


def test_the_reference_refuses_another_class():
    with pytest.raises(ValueError):
        drcnn.build({"class": "basic_cnn_segm_sigmoid", "args": TINY})


def counted(args, batch, train, device="cpu"):
    with torch.device(device):
        m = drcnn.build({"class": CLASS, "args": args})
        x = torch.zeros(batch, 6, 75, args["n_bins_in"])
        with FlopCounterMode(display=False) as fc:
            y = m(x)
            if train:
                y.sum().backward()
    return fc.get_total_flops()


@pytest.mark.parametrize("residual", [True, False])
def test_counts_equal_flop_counter_at_tiny_widths(residual):
    args = {**TINY, "residual": residual}
    assert counts.forward_flops(args, 3) == counted(args, 3, False)
    assert counts.train_step_flops(args, 3) == counted(args, 3, True)
    assert counts.forward_flops(args, 4, 2) == counts.forward_flops(args, 4)


def test_counts_at_the_published_widths():
    args = PUBLISHED["model"]["args"]
    assert counts.forward_flops(args, 1) == counted(args, 1, False, "meta") \
        == 146_459_953_440
    assert counts.train_step_flops(args, 25) == \
        counted(args, 25, True, "meta") == 10_984_496_508_000
    with torch.device("meta"):
        n = sum(p.numel() for p in common.reference(PUBLISHED).parameters())
    assert n == PUBLISHED["parameters"] == 4_814_683


@pytest.mark.parametrize("residual,adds", [(True, 2), (False, 0),
                                           (None, 0)])
def test_spans_and_the_residual_counter(residual, adds):
    """With recording on, a forward opens ``cnn.prefilter`` and
    ``cnn.head`` once each, and the shortcuts show as the adds inside
    ``cnn.prefilter``: DRCNN takes ``n_prefilt_layers - 1`` per forward;
    DCNN and CNN:M (``basic_cnn_segm_sigmoid``, ``residual`` None here)
    take none. With recording off both spans are the shared no-op."""
    if residual is None:
        port = build_model("basic_cnn_segm_sigmoid", {
            k: v for k, v in TINY.items() if k != "n_prefilt_layers"})
    else:
        port = build_model(CLASS, {**TINY, "residual": residual})
    port.eval()
    x, _ = window(batch=1)
    assert profiling.span("cnn.head") is profiling.span("cnn.prefilter")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            recording(), torch.no_grad():
        port(x.float())
    events = prof.events()
    names = [e.name for e in events]
    assert names.count("mpa.cnn.prefilter") == 1
    assert names.count("mpa.cnn.head") == 1
    pre = events[names.index("mpa.cnn.prefilter")].time_range
    inside = [e.name for e in events
              if pre.start <= e.time_range.start <= e.time_range.end
              <= pre.end]
    assert inside.count("aten::add") == adds


def fake_run(kernels_s, steps=2, busy=True):
    spans = [("step", float(i), i + 0.5) for i in range(steps)] + \
        [("data", 0.0, 0.1)]
    return SimpleNamespace(profile={
        "busy": [[0.0, 1.0]] if busy else [], "spans": spans,
        "kernels_s": kernels_s})


KERNELS = {
    "void DSE::regular_fft_pad<0, 1, 128, 16, 32, 1, float, float, "
    "float2>(float2*, float*, int)": 0.010,
    "fft2d_r2c_32x32<float, false, 1u, false>": 0.004,
    "sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8_stage3_"
    "warpsize2x2x1_ffma_aligna8_alignc8_execute_kernel__5x_cudnn": 0.030,
    "void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, "
    "false, false, true>(int, int, int)": 0.100,
    "sm80_xmma_fprop_implicit_gemm_indexed_f32f32_f32f32_f32_nchwkcrs_"
    "nchw_tilesize32x32x8": 0.002,
    "void cudnn::cnn::wgrad2d_grouped_direct_kernel<false, true, int>": 0.050,
    "sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 0.006,
    "void at::native::(anonymous namespace)::max_pool_forward_nchw<float, "
    "float>": 0.020,
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "direct_copy_kernel_cuda>": 0.001,
}


def test_the_convolution_family_readers():
    fft = common.metric_reader("fft_conv_ms_per_step.drcnn")
    conv = common.metric_reader("conv_ms_per_step.drcnn")
    run = fake_run(KERNELS)
    assert fft(run) == pytest.approx(1e3 * 0.044 / 2)
    assert conv(run) == pytest.approx(1e3 * 0.158 / 2)
    assert [convs.family(k) for k in KERNELS] == [
        "fft", "fft", "fft", "conv", "conv", "conv", "conv", None, None]
    # nothing to read: no profile, no steps profiled, no device work
    for empty in (SimpleNamespace(profile=None), fake_run(KERNELS, steps=0),
                  fake_run({}, busy=False)):
        assert fft(empty) is None and conv(empty) is None


REFERENCE_IMPORT = r"""
import json, sys
import portbench.reference.drcnn, portbench.counts.drcnn, portbench.convs
print(json.dumps(sorted(sys.modules)))
"""


def test_the_reference_loads_neither_jax_nor_the_port():
    out = subprocess.run([sys.executable, "-c", REFERENCE_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(
        out.stdout.strip().splitlines()[-1])}
    assert not tops & set(common.FORBIDDEN)
    assert "multipitch_architectures_tpu_torch" not in tops
