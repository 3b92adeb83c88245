"""Seeds, file lookup and the table of peaks."""

import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# NVIDIA H100 SXM data sheet, dense rates, at the 700-W power limit
PEAKS = {
    "tf32_flop_per_s": 495e12,
    "fp32_flop_per_s": 67e12,
    "bf16_flop_per_s": 989e12,
    "int8_op_per_s": 1979e12,
    "hbm_bytes_per_s": 3.35e12,
}
# the rate that an mfu or a roofline share divides by: float32 work that
# tensor cores can do at float32 accuracy (split TF32) is bounded by the
# dense TF32 rate, not by the CUDA cores' 67 TFLOP/s
FLOAT32_PEAK = PEAKS["tf32_flop_per_s"]

# module names that no run may hold (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multipitch_architectures_tpu")


def stream(seed, *path):
    """A numpy Generator that is a pure function of the run's seed and a
    stream path."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1)] + [int(p) for p in path]))


def stream_seed(seed, *path):
    """A 63-bit integer seed of the stream ``path`` (torch generators)."""
    return int(stream(seed, *path).integers(0, 2 ** 63 - 1))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def traffic_file(name, root=ROOT):
    return load_json(os.path.join(root, "portbench", "traffic",
                                  f"{name}.json"))


def metric_reader(name, root=ROOT):
    """``read`` of ``portbench/metrics/<name>.py`` or, where there is
    none, of the reader that the name's family shares, the name cut at
    its last dot (``frontend_ms_per_audio_s.clips`` reads with
    ``frontend_ms_per_audio_s.py``)."""
    stem = name
    path = os.path.join(root, "portbench", "metrics", f"{stem}.py")
    while not os.path.exists(path) and "." in stem:
        stem = stem.rsplit(".", 1)[0]
        path = os.path.join(root, "portbench", "metrics", f"{stem}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def part(kind, name, root=ROOT):
    """The module ``portbench/<kind>/<name>.py`` under ``root``: the plain
    reference (``kind`` "reference", a ``build(model_cfg)``) or the
    counts (``kind`` "counts", ``forward_flops`` and
    ``train_step_flops``) that a configuration names. It is loaded as
    ``portbench.<kind>.<name>``, so that its relative imports reach the
    harness's own modules."""
    full = f"portbench.{kind}.{name}"
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    mod = sys.modules.get(full)
    if mod is not None and os.path.samefile(mod.__file__, path):
        return mod
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cfg, root=ROOT):
    """The plain reference model of configuration ``cfg``, on the current
    default device."""
    return part("reference", cfg["reference"], root).build(cfg["model"])


def counts(cfg, root=ROOT):
    return part("counts", cfg["counts"], root)


def forbidden_modules(modules):
    """Loaded module names whose top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
