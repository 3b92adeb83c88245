"""The port stands alone: importing every module of
``multipitch_architectures_tpu_torch``, and ``chip_smoke.py``, loads
neither JAX nor flax nor optax (nor the JAX package, whose subpackages
import them). Checked in a fresh interpreter, since this test process
already holds JAX. And its entry points never fall back to the CPU:
without a card they raise unless given ``device="cpu"``."""

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
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "multipitch_architectures_tpu"))
print(len(names), loaded)
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    n_modules, loaded = r.stdout.split(" ", 1)
    assert int(n_modules) >= 32
    assert loaded.strip() == "[]"


def test_entry_points_raise_without_a_card_unless_given_the_cpu(
        monkeypatch, tmp_path):
    from multipitch_architectures_tpu_torch import resolve_device
    from multipitch_architectures_tpu_torch.data import (FileSpec,
                                                         TrainPipeline)
    from multipitch_architectures_tpu_torch.experiments import (
        SyntheticCorpus, load_experiment, run_experiment, shrink_for_smoke)
    from multipitch_architectures_tpu_torch.experiments import run as cli
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
                               str(tmp_path / "cli")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "run").exists()     # raised before any work
    assert resolve_device("cpu") == torch.device("cpu")
    assert len(TrainPipeline(files, device="cpu")) == 0
    assert Trainer(torch.nn.Linear(2, 2), TrainConfig(),
                   device="cpu").device.type == "cpu"
