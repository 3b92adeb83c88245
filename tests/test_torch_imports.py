"""The port stands alone: importing every module of
``multipitch_architectures_tpu_torch``, and ``chip_smoke.py``, loads
neither JAX nor flax (nor the JAX package, whose subpackages import
them). Checked in a fresh interpreter, since this test process already
holds JAX."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import multipitch_architectures_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "multipitch_architectures_tpu"))
print(len(names), loaded)
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    n_modules, loaded = r.stdout.split(" ", 1)
    assert int(n_modules) >= 18
    assert loaded.strip() == "[]"
