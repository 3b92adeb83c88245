"""Every command-line entry point of the port computes float32: each
CLI's ``main`` turns TF32 off for cuDNN and matmuls (``set_f32_parity``),
whatever the process had set, as the parity path does. And ``run
--profile DIR`` writes a Chrome trace of the run, as the JAX CLI's
``--profile`` does (``experiments/run.py:52-54``).

Each CLI runs on the CPU at the cheapest size that reaches past argument
parsing: ``run`` with ``run_experiment`` replaced, ``precompute`` on one
1-s WAV, ``export`` on a tiny CNN, ``predict`` on its checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import multipitch_architectures_tpu_torch.experiments as exp
from multipitch_architectures_tpu_torch.experiments import (
    build_model, export, precompute, predict)
from multipitch_architectures_tpu_torch.experiments import run as cli
from multipitch_architectures_tpu_torch.models import init_parameters
from multipitch_architectures_tpu_torch.serve import export_window_forward

EXP180D = "exp180d_musicnet_unet_extremelylarge_doubleselfattn"
CNN = "basic_cnn_segm_sigmoid"
CNN_ARGS = {"n_chan_layers": [8, 8, 4, 2], "n_bins_out": 72}
FS = 22050
FRAMES = 9


@pytest.fixture
def tf32_on():
    """Both TF32 flags on, as a process may have them; restored after."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = before


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny CNN's checkpoint and artifact, a seeded HCQT (216, T, 6),
    and a 1-s WAV with a MusicNet csv."""
    root = tmp_path_factory.mktemp("cli")
    model = build_model(CNN, CNN_ARGS)
    init_parameters(model, torch.Generator().manual_seed(0))
    out = {"root": root, "checkpoint": str(root / "cnn.pt"),
           "hcqt": str(root / "hcqt.npy"), "artifact": str(root / "a.mptpu")}
    torch.save(model.state_dict(), out["checkpoint"])
    (root / "a.mptpu").write_bytes(export_window_forward(
        model.eval(), batch_size=4))
    np.save(out["hcqt"], np.random.RandomState(0).rand(
        216, FRAMES, 6).astype(np.float32))
    for sub in ("audio", "csv"):
        (root / sub).mkdir()
    t = np.arange(FS) / FS
    wavfile.write(root / "audio" / "clip.wav", FS,
                  (0.5 * 32767 * np.sin(2 * np.pi * 440 * t)).astype(
                      np.int16))
    (root / "csv" / "clip.csv").write_text(
        "start_time,end_time,instrument,note\n0,44100,1,69\n")
    return out


def _fake_run(cfg, corpus, out_dir, **kw):
    return {}


def _run(files, tmp_path, monkeypatch):
    monkeypatch.setattr(exp, "run_experiment", _fake_run)
    return cli.main(["--config", EXP180D, "--smoke", "--cpu", "--out-dir",
                     str(tmp_path)])


def _precompute(files, tmp_path, monkeypatch):
    root = files["root"]
    return precompute.main(["--audio-dir", str(root / "audio"), "--csv-dir",
                            str(root / "csv"), "--out-dir", str(tmp_path),
                            "--cpu"])


def _export(files, tmp_path, monkeypatch):
    return export.main(["export", "--model", CNN, "--model-args",
                        json.dumps(CNN_ARGS), "--checkpoint",
                        files["checkpoint"], "--batch-size", "4",
                        "--device", "cpu", "--out", str(tmp_path / "a")])


def _export_predict(files, tmp_path, monkeypatch):
    return export.main(["predict", "--artifact", files["artifact"], "--hcqt",
                        files["hcqt"], "--device", "cpu", "--out",
                        str(tmp_path / "p.npy")])


def _predict(files, tmp_path, monkeypatch):
    return predict.main(["--checkpoint", files["checkpoint"], "--model", CNN,
                         "--model-args", json.dumps(CNN_ARGS), "--hcqt",
                         files["hcqt"], "--batch-size", "4", "--device",
                         "cpu", "--out", str(tmp_path / "p.npy")])


@pytest.mark.parametrize("command", [_run, _precompute, _export,
                                     _export_predict, _predict],
                         ids=["run", "precompute", "export export",
                              "export predict", "predict"])
def test_cli_turns_tf32_off(command, files, tmp_path, monkeypatch, tf32_on):
    assert command(files, tmp_path, monkeypatch) == 0
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_run_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    """``--profile DIR``: the run inside the profiler, its trace written
    to ``DIR/trace.json`` with the run's ops; without it, no profiler."""
    seen = []

    def fake_run(cfg, corpus, out_dir, **kw):
        seen.append(torch.autograd._profiler_enabled())
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
        return {}

    monkeypatch.setattr(exp, "run_experiment", fake_run)
    argv = ["--config", EXP180D, "--smoke", "--cpu", "--out-dir",
            str(tmp_path / "run")]
    assert cli.main(argv + ["--profile", str(tmp_path / "prof")]) == 0
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert "aten::mm" in {e.get("name") for e in events}
    assert cli.main(argv) == 0
    assert seen == [True, False]
    assert os.listdir(tmp_path / "prof") == ["trace.json"]
