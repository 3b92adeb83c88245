"""The port's ``utils`` against the JAX package's logged figures, on the
CPU: ``count_macs`` (the reference's torchinfo 'Total mult-adds', which
the JAX package reproduces), ``model_summary``'s parameter count,
``device_sync`` and ``trace``."""

import json

import pytest
import torch

from multipitch_architectures_tpu_torch.experiments import load_experiment
from multipitch_architectures_tpu_torch.models import (
    BasicCnnSegmSigmoid, DeepCnnSegmSigmoid, SimpleUNetDoubleSelfAttn)
from multipitch_architectures_tpu_torch.utils import (
    count_macs, device_sync, model_summary, plot_matrix, trace)

SUMMARY_INPUT = (1, 6, 174, 216)   # the reference's summary input, exp180d:233


@pytest.mark.parametrize("name,build,low,high", [
    # tests/test_experiments.py: exp126c log:53, exp127c log:74, exp180d
    # log:143 plus the attention products old torchinfo misses
    ("CNN:M", lambda: BasicCnnSegmSigmoid(n_chan_layers=(250, 150, 100, 100),
                                          n_bins_out=72), 25.085, 25.095),
    ("DCNN:L", lambda: DeepCnnSegmSigmoid(
        n_chan_layers=(70, 70, 50, 10), n_prefilt_layers=5, residual=False,
        n_bins_out=72), 171.73, 171.77),
    ("SAUnet:L", lambda: SimpleUNetDoubleSelfAttn(
        n_chan_layers=(128, 80, 50, 30), n_bins_out=72, scalefac=4,
        embed_dim=128, num_heads=8, mlp_dim=8192,
        pos_encoding="sinusoidal"), 35.51, 36.6),
])
def test_count_macs_matches_the_logged_figures(name, build, low, high):
    """The JAX package's figures: CNN:M 25.09 G, DCNN:L 171.75 G ± 0.02,
    SAUnet:L 35.51–36.6 G at (1, 6, 174, 216); the model stays on its
    device, in its mode."""
    model = build().train()
    macs = count_macs(model, SUMMARY_INPUT) / 1e9
    assert low <= macs <= high, (name, macs)
    assert model.training
    assert next(model.parameters()).device.type == "cpu"


def test_count_macs_of_exp180e_per_window():
    """exp180e's 41.60 G per 75-frame window, the JAX package's count."""
    model = load_experiment(
        "exp180e_musicnet_unet_insanelylarge_doubleselfattn").build_model()
    assert round(count_macs(model, (1, 6, 75, 216)) / 1e9, 2) == 41.60


def test_model_summary_counts():
    s = model_summary(BasicCnnSegmSigmoid(n_chan_layers=(20, 20, 10, 1),
                                          n_bins_out=72))
    assert "Total params: 48,255" in s          # tests/test_ops.py:79
    assert "Total mult-adds (G):" in s


def test_device_sync():
    """A no-op on the CPU, for the current card and for a tensor."""
    device_sync()
    device_sync(torch.ones(2))


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_plot_matrix(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    ax = plot_matrix(torch.rand(72, 50), fs=43.07, title="salience")
    assert ax.get_title() == "salience"
    ax.figure.savefig(tmp_path / "m.png")
    assert (tmp_path / "m.png").stat().st_size > 0
