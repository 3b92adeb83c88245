"""Experiment configurations.

Counterpart of ``multipitch_architectures_tpu/experiments/configs.py``.
The registry is data: the JAX package's ``experiments/registry.json``
(the configuration values of the reference's 111 experiment scripts) is
read by file path, without importing that package. So far the port reads
the fields the serving path needs: the model class and its arguments.
"""

import inspect
import json
import os
from dataclasses import dataclass

from ..models import SimpleUNetDoubleSelfAttn

REGISTRY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "multipitch_architectures_tpu", "experiments", "registry.json")

# reference class name -> this package's module
MODEL_REGISTRY = {
    "simple_u_net_doubleselfattn": SimpleUNetDoubleSelfAttn,
}


def build_model(model_class: str, model_kwargs: dict, **overrides):
    """Build ``model_class`` from registry ``model_kwargs`` (keys the
    class does not take, such as ``n_ch_out``, are dropped; lists become
    tuples) and ``overrides`` (e.g. ``attn_mode='cross_batch:50'``)."""
    if model_class not in MODEL_REGISTRY:
        raise KeyError(f"model class {model_class!r} is not ported yet; "
                       f"ported: {sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[model_class]
    accepted = inspect.signature(cls).parameters
    kwargs = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in model_kwargs.items() if k in accepted}
    return cls(**{**kwargs, **overrides})


@dataclass
class ExperimentConfig:
    name: str
    model_class: str
    model_kwargs: dict

    def build_model(self, **overrides):
        return build_model(self.model_class, self.model_kwargs, **overrides)


def load_experiment(name: str,
                    registry_path: str = REGISTRY_PATH) -> ExperimentConfig:
    with open(registry_path) as f:
        raw = json.load(f)[name]
    return ExperimentConfig(
        name=name,
        model_class=raw["model_class"],
        model_kwargs=raw.get("model_params", {}),
    )
