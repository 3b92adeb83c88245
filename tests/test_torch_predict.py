"""The port's pretrained-prediction CLI (``experiments/predict.py``)
against the JAX package's ``examples/predict_pretrained.py``, on the CPU.

Both read the same ``.pt``: the ``state_dict`` of a seeded port model at
tiny widths, in the reference's key layout, which the example ports to
flax by its class-family dispatch; and the same numpy-seeded inputs. The
example runs in this process through ``runpy`` with its argv (its JAX on
the CPU, as the conftest sets it). Tolerances: float32 predictions
1e-4 max abs (2e-4 for the U-Nets, the zoo tests' own); ``--audio``
the same; ``--int8`` outputs of two programs differ by bin flips, so
they are held by the worst of the 25 measures' drift, 1e-3, as
``eval/quant.py``'s gate holds int8 against float32.
"""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.eval.quant import measure_drift
from multipitch_architectures_tpu_torch.experiments import (
    build_model, predict_pretrained)
from multipitch_architectures_tpu_torch.experiments.predict import main
from multipitch_architectures_tpu_torch.models import init_parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "predict_pretrained.py")
TINY = dict(n_chan_layers=[8, 8, 4, 2], n_bins_out=72)
UNET = dict(TINY, scalefac=16)
ATTN = dict(embed_dim=32, num_heads=8, mlp_dim=64)
# one class of each family of the example's ``port_state_dict`` dispatch:
# name -> (reference class, its arguments, atol)
FAMILIES = {
    "cnn": ("basic_cnn_segm_sigmoid", TINY, 1e-4),
    "dcnn": ("deep_cnn_segm_sigmoid", dict(TINY, n_prefilt_layers=2), 1e-4),
    "saunet": ("simple_u_net_doubleselfattn", dict(UNET, **ATTN), 2e-4),
    "freq": ("freq_u_net_selfattn",
             dict(TINY, n_chan_layers=[32, 8, 4, 2], scalefac=2, **ATTN),
             2e-4),
    "punet": ("simple_u_net_polyphony_classif_softmax",
              dict(UNET, num_polyphony_steps=24), 2e-4),
}
FRAMES = 60
BATCH = 30          # two full batches: one compile on each side
INT8_BATCH = 10     # 60 frames: 40 in the calibration span, 20 in int8
INT8_GATE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{family: its .pt}, and the seeded HCQT (216, T, 6) and 3-s audio
    .npy files."""
    root = tmp_path_factory.mktemp("predict")
    out = {}
    for i, (name, (cls, kwargs, _)) in enumerate(sorted(FAMILIES.items())):
        model = build_model(cls, kwargs)
        init_parameters(model, torch.Generator().manual_seed(i))
        out[name] = str(root / f"{name}.pt")
        torch.save(model.state_dict(), out[name])
    rng = np.random.RandomState(0)
    out["hcqt"] = str(root / "hcqt.npy")
    np.save(out["hcqt"], rng.rand(216, FRAMES, 6).astype(np.float32))
    t = np.arange(3 * 22050) / 22050.0
    out["audio"] = str(root / "audio.npy")
    np.save(out["audio"], (0.3 * np.sin(2 * np.pi * 440.0 * t)
                           + 0.2 * np.sin(2 * np.pi * 659.26 * t)
                           + 0.05 * rng.randn(t.size)).astype(np.float32))
    out["root"] = root
    return out


def _example(monkeypatch, tmp_path, argv):
    """``examples/predict_pretrained.py`` with ``argv``, in this process:
    (prediction, polyphony logits or None)."""
    out = str(tmp_path / "jax.npy")
    # the example points JAX's compilation cache at /tmp unless one is set
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(sys, "argv", [EXAMPLE] + argv + ["--out", out])
    runpy.run_path(EXAMPLE, run_name="__main__")
    poly = out.replace(".npy", "_polyphony.npy")
    return np.load(out), (np.load(poly) if os.path.exists(poly) else None)


def _port(tmp_path, argv):
    out = str(tmp_path / "port.npy")
    assert main(argv + ["--out", out, "--device", "cpu"]) == 0
    poly = out.replace(".npy", "_polyphony.npy")
    return np.load(out), (np.load(poly) if os.path.exists(poly) else None)


def _argv(files, name, *extra, batch=BATCH):
    cls, kwargs, _ = FAMILIES[name]
    return ["--checkpoint", files[name], "--model", cls, "--model-args",
            json.dumps(kwargs), "--batch-size", str(batch), *extra]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_predict_cli_matches_the_jax_example(files, name, monkeypatch,
                                             tmp_path):
    argv = _argv(files, name, "--hcqt", files["hcqt"])
    want, want_poly = _example(monkeypatch, tmp_path, argv)
    got, poly = _port(tmp_path, argv)
    assert got.shape == want.shape == (FRAMES, 72)
    np.testing.assert_allclose(got, want, rtol=0, atol=FAMILIES[name][2])
    if name == "punet":
        assert poly.shape == want_poly.shape == (FRAMES, 24)
        np.testing.assert_allclose(poly, want_poly, rtol=0,
                                   atol=FAMILIES[name][2] * max(
                                       1.0, np.abs(want_poly).max()))
    else:
        assert poly is None and want_poly is None


def test_predict_cli_from_audio_matches_the_jax_example(files, monkeypatch,
                                                        tmp_path):
    """``--audio``: the HCQT of a seeded 3-s signal (the port's plain
    CQT on the CPU), then the CNN; and the library call it wraps."""
    argv = _argv(files, "cnn", "--audio", files["audio"])
    want, _ = _example(monkeypatch, tmp_path, argv)
    got, _ = _port(tmp_path, argv)
    assert got.shape == want.shape and got.shape[1] == 72
    np.testing.assert_allclose(got, want, rtol=0, atol=FAMILIES["cnn"][2])
    cls, kwargs, _ = FAMILIES["cnn"]
    again = predict_pretrained(files["cnn"], cls, kwargs, audio=files["audio"],
                               batch_size=BATCH, device="cpu")
    np.testing.assert_array_equal(again, got)


def test_predict_cli_int8_matches_the_jax_example(files, monkeypatch,
                                                  tmp_path):
    """``--int8`` (calibrated on the recording's first 4 batches of 10,
    which are served from the float32 calibration pass; the last 20
    frames in int8): the worst of the 25 measures' drift between the two
    int8 outputs within the gate."""
    argv = _argv(files, "cnn", "--hcqt", files["hcqt"], "--int8",
                 batch=INT8_BATCH)
    want, _ = _example(monkeypatch, tmp_path, argv)
    got, _ = _port(tmp_path, argv)
    f32, _ = _port(tmp_path, [a for a in argv if a != "--int8"])
    assert got.shape == want.shape == (FRAMES, 72)
    np.testing.assert_array_equal(got[:4 * INT8_BATCH],
                                  f32[:4 * INT8_BATCH])
    assert np.abs(got - f32).max() > 1e-6
    drift, _ = measure_drift(want, got)
    assert drift and max(drift.values()) <= INT8_GATE, drift


def test_predict_cli_without_a_card_stops(files):
    """Without a card and without ``--device cpu`` the CLI exits
    non-zero, and writes nothing."""
    out = str(files["root"] / "none.npy")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m",
         "multipitch_architectures_tpu_torch.experiments.predict",
         *_argv(files, "cnn", "--hcqt", files["hcqt"]), "--out", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not os.path.exists(out)
