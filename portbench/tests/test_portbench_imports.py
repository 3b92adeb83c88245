"""Nothing the harness or the reference loads is JAX or the JAX package,
and the reference loads nothing of the program under test."""

import json
import os
import subprocess
import sys

from portbench.common import FORBIDDEN, ROOT, forbidden_modules

HARNESS_RUN = r"""
import json, sys, tempfile, torch
torch.set_num_threads(2)
from portbench.tests.tiny import make_root
from portbench.run import run_cell
root = make_root(tempfile.mkdtemp())
run_cell("exp180e-f32.clips", 5, 1.0, 0, root=root, require_card=False)
run_cell("exp180d-f32.train", 5, 1.0, 1, root=root, require_card=False)
run_cell("exp180e-int8.corpus", 5, 1.0, 1, root=root, require_card=False)
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_IMPORT = r"""
import json, sys
import portbench.reference.frontend, portbench.reference.protocol
import portbench.reference.saunet, portbench.reference.train
import portbench.reference.quant, portbench.counts.int8
import portbench.counts.saunet, portbench.counts.cqt, portbench.traffic
print(json.dumps(sorted(sys.modules)))
"""


def modules_of(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["multipitch_architectures_tpu_torch.dsp",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "multipitch_architectures_tpu",
                              "flax.linen"]) == [
        "flax.linen", "jax.numpy", "multipitch_architectures_tpu"]


def test_a_run_loads_no_jax():
    mods = modules_of(HARNESS_RUN)
    assert "multipitch_architectures_tpu_torch" in mods
    assert forbidden_modules(mods) == []


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = modules_of(REFERENCE_IMPORT)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(FORBIDDEN)
    assert "multipitch_architectures_tpu_torch" not in tops
