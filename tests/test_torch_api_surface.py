"""The port's public surface against the JAX package's, without importing
either package's modules: each JAX module is parsed with ``ast``, and
each public name (a top-level function, class or assignment; in an
``__init__``, also a relative import) needs a counterpart of the same
name in the port's module of the same path. Two lists make the
exceptions:

- ``NOT_YET``: names that later work ports (ROADMAP.md, queue 1). The
  test fails once a listed name exists in the port, so the list shrinks
  with the port and cannot go stale;
- ``BY_DESIGN``: names with no port: the flax- and optax-only names, the
  Pallas kernel (its counterpart is ``ops/cqt_octave.py``) and the
  reverse weight porters (their counterpart is
  ``models.state_dict_from_flax``).

Also: every registry entry builds on the ``meta`` device, and
``build_model`` drops no registry model argument but ``n_ch_out``; both
``MODEL_REGISTRY``s hold the same 26 classes, and each port constructor
takes every field of its JAX dataclass, so that ``build_model`` cannot
drop one silently (``alt_order`` once was).
"""

import ast
import inspect
import os

import torch

from multipitch_architectures_tpu_torch.experiments import (
    MODEL_REGISTRY, available_experiments, load_experiment)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "multipitch_architectures_tpu")
PORT = os.path.join(ROOT, "multipitch_architectures_tpu_torch")

# every name of the JAX package now has its port (the list shrank to
# nothing as the slices landed; it stays for names that a later JAX
# change adds)
NOT_YET = {}

_FLAX_INT8 = {"SCALES_COLLECTION", "make_int8_interceptor",
              "quantized_apply_fn", "quantized_serving_fn"}
BY_DESIGN = {
    "train/__init__.py": {"TrainState"},
    "train/trainer.py": {"TrainState"},
    "train/schedulers.py": {"noam_optax_schedule"},
    "eval/__init__.py": _FLAX_INT8,
    "eval/quant.py": _FLAX_INT8,
    "ops/pallas_cqt.py": {"cqt_octave_pallas"},
    "models/port.py": {"export_state_dict", "port_basic_cnn",
                       "port_basic_cnn_segm", "port_basic_cnn_segm_blank",
                       "port_deep_cnn_segm_sigmoid",
                       "port_freq_u_net_selfattn", "port_simple_u_net",
                       "port_unet_auto", "port_unet_transenc"},
}


def public_names(path):
    """Top-level public names of a module file, by ``ast``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif path.endswith("__init__.py") and \
                isinstance(node, ast.ImportFrom) and node.level:
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def jax_modules():
    """{path relative to the package: public names} of the JAX package."""
    out = {}
    for root, _, files in os.walk(JAX):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                out[os.path.relpath(path, JAX)] = public_names(path)
    return out


def port_names(rel):
    path = os.path.join(PORT, rel)
    return public_names(path) if os.path.isfile(path) else set()


def test_every_jax_public_name_has_a_port_counterpart():
    missing = {}
    for rel, names in sorted(jax_modules().items()):
        want = names - NOT_YET.get(rel, set()) - BY_DESIGN.get(rel, set())
        gap = want - port_names(rel)
        if gap:
            missing[rel] = sorted(gap)
    assert not missing, f"no port counterpart (port them, or list them " \
                        f"in NOT_YET or BY_DESIGN): {missing}"


def test_not_yet_names_are_still_missing():
    """A name that the port now has leaves NOT_YET."""
    ported = {rel: sorted(names & port_names(rel))
              for rel, names in NOT_YET.items() if names & port_names(rel)}
    assert not ported, f"ported now, remove from NOT_YET: {ported}"


def test_exception_lists_name_jax_names():
    jax = jax_modules()
    for table in (NOT_YET, BY_DESIGN):
        for rel, names in table.items():
            assert rel in jax and names <= jax[rel], (rel, names - jax[rel])


def test_every_registry_entry_builds_and_keeps_its_arguments():
    """All 111 entries build (on the ``meta`` device: shapes, no storage)
    and their classes take every registry model argument but
    ``n_ch_out``, which the reference's models never read."""
    names = available_experiments()
    assert len(names) == 111
    classes = set()
    for name in names:
        cfg = load_experiment(name)
        cls = MODEL_REGISTRY[cfg.model_class]
        taken = inspect.signature(cls).parameters
        dropped = set(cfg.model_kwargs) - set(taken)
        assert dropped <= {"n_ch_out"}, (name, dropped)
        with torch.device("meta"):
            model = cfg.build_model()
        assert isinstance(model, cls)
        for key, value in cfg.model_kwargs.items():
            if key in taken and hasattr(model, key):
                assert getattr(model, key) == value, (name, key)
        classes.add(cfg.model_class)
    # the entries use 7 of the registry's 26 classes
    assert classes <= set(MODEL_REGISTRY) and len(classes) == 7


def test_registries_match_and_constructors_take_every_jax_field():
    """The two ``MODEL_REGISTRY``s have the same 26 keys, and each port
    class's constructor accepts every field of the JAX dataclass (all but
    flax's ``parent`` and ``name``)."""
    import dataclasses

    from multipitch_architectures_tpu.experiments.configs import \
        MODEL_REGISTRY as JAX_REGISTRY

    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    assert len(MODEL_REGISTRY) == 26
    missing = {}
    for key, jcls in JAX_REGISTRY.items():
        fields = {f.name for f in dataclasses.fields(jcls)} - {"parent",
                                                               "name"}
        gap = fields - set(inspect.signature(MODEL_REGISTRY[key]).parameters)
        if gap:
            missing[key] = sorted(gap)
    assert not missing, f"fields the port's constructors drop: {missing}"
