"""The port stands alone: importing every module of
``multipitch_architectures_tpu_torch``, and ``chip_smoke.py``, loads
neither JAX nor flax nor optax (nor the JAX package, whose subpackages
import them), nor pandas or sklearn (the machine with the card has
neither); reading note events loads no pandas either, lazily or not.
Checked in a fresh interpreter, since this test process already holds
JAX. And its entry points never fall back to the CPU: without a card
they raise unless given ``device="cpu"``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import multipitch_architectures_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert {pkg.__name__ + m for m in (".data.datasets", ".io.native_loader",
                                    ".models.unets", ".models.cnns")} <= set(names)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "multipitch_architectures_tpu",
                                       "pandas", "sklearn"))
print(len(names), loaded)
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    n_modules, loaded = r.stdout.split(" ", 1)
    assert int(n_modules) >= 51
    assert loaded.strip() == "[]"


# every preset and both auto-detected schemas, with pandas made
# unimportable: a lazy ``import pandas`` inside the readers would raise
NO_PANDAS = """
import os, sys, tempfile
sys.modules["pandas"] = None
from multipitch_architectures_tpu_torch.io import (NOTE_EVENT_SCHEMAS,
                                                   load_note_events)
files = {
    None: "start_time,end_time,instrument,note\\n0,44100,1,69\\n",
    "musicnet": "start_time,end_time,instrument,note\\n0,44100,1,69\\n",
    "swd": "start;end;pitch\\n0.5;1.0;69\\n",
    "bach10": "500 1000 69\\n",
    "phenicx": "onset,offset,note\\n0.5,1.0,A4\\n",
    "csd": "0.5,440.0\\n0.51,440.0\\n",
}
files["swd auto"] = files["swd"]
assert set(files) - {None, "swd auto"} == set(NOTE_EVENT_SCHEMAS)
with tempfile.TemporaryDirectory() as tmp:
    for schema, text in files.items():
        path = os.path.join(tmp, "a.csv")
        with open(path, "w") as f:
            f.write(text)
        ev = load_note_events(path, schema=None if schema in (
            None, "swd auto") else schema)
        assert ev.shape[1] == 3 and (ev[:, 2] == 69).all(), (schema, ev)
print(len(files), "pandas" in sys.modules and sys.modules["pandas"])
"""


def test_note_events_read_without_pandas():
    r = subprocess.run([sys.executable, "-c", NO_PANDAS], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["7", "None"]


def test_entry_points_raise_without_a_card_unless_given_the_cpu(
        monkeypatch, tmp_path):
    from multipitch_architectures_tpu_torch import resolve_device
    from multipitch_architectures_tpu_torch.data import (FileSpec,
                                                         TrainPipeline)
    from multipitch_architectures_tpu_torch.dsp import (
        compute_efficient_hcqt, compute_hcqt)
    from multipitch_architectures_tpu_torch.experiments import (
        AudioCorpus, SyntheticCorpus, load_experiment, run_experiment,
        shrink_for_smoke)
    from multipitch_architectures_tpu_torch.experiments import export
    from multipitch_architectures_tpu_torch.experiments import precompute
    from multipitch_architectures_tpu_torch.experiments import run as cli
    from multipitch_architectures_tpu_torch.serve import load_window_forward
    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    files = [FileSpec(np.zeros((6, 100, 216), np.float32),
                      np.zeros((100, 128), np.float32))]
    cfg = shrink_for_smoke(load_experiment(
        "exp180d_musicnet_unet_extremelylarge_doubleselfattn"))
    calls = [lambda: resolve_device(),
             lambda: TrainPipeline(files),
             lambda: Trainer(torch.nn.Linear(2, 2), TrainConfig()),
             lambda: run_experiment(cfg, SyntheticCorpus(cfg),
                                    str(tmp_path / "run")),
             lambda: cli.main(["--config", cfg.name, "--smoke", "--out-dir",
                               str(tmp_path / "cli")]),
             lambda: compute_efficient_hcqt(np.zeros(2048, np.float32)),
             lambda: compute_hcqt(np.zeros(2048, np.float32)),
             lambda: AudioCorpus(str(tmp_path), str(tmp_path)).load("a.wav"),
             lambda: cli.main(["--config", cfg.name, "--audio-dir",
                               str(tmp_path), "--csv-dir", str(tmp_path),
                               "--out-dir", str(tmp_path / "cli")]),
             lambda: precompute.main(["--audio-dir", str(tmp_path),
                                      "--csv-dir", str(tmp_path),
                                      "--out-dir", str(tmp_path / "pre")]),
             lambda: load_window_forward(b""),
             lambda: export.main(["export", "--config", cfg.name, "--out",
                                  str(tmp_path / "art")]),
             lambda: export.main(["predict", "--artifact",
                                  str(tmp_path / "art"), "--hcqt",
                                  str(tmp_path / "h.npy"), "--out",
                                  str(tmp_path / "pred.npy")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for out in ("run", "cli", "pre", "art", "pred.npy"):   # before any work
        assert not (tmp_path / out).exists()
    assert resolve_device("cpu") == torch.device("cpu")
    assert len(TrainPipeline(files, device="cpu")) == 0
    assert Trainer(torch.nn.Linear(2, 2), TrainConfig(),
                   device="cpu").device.type == "cpu"
