"""Parameter counts of the zoo's 19 classes that chip_smoke.py's phase 12
serves, at its full-width configurations (``chip_smoke.ZOO2``): the
port's, built on the ``meta`` device, equal the JAX package's, traced
abstractly by ``jax.eval_shape`` (nothing computed), so that the card
runs the models that the CPU tests vouch for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.experiments.configs import \
    MODEL_REGISTRY as JAX_REGISTRY
from multipitch_architectures_tpu_torch.experiments import build_model

import chip_smoke


@pytest.mark.parametrize("name", [name for name, _, _ in chip_smoke.ZOO2])
def test_full_width_parameter_counts_are_the_jax_models(name):
    kw = chip_smoke.zoo2_kwargs(name)
    with torch.device("meta"):
        tm = build_model(name, kw)
    shapes = jax.eval_shape(lambda: JAX_REGISTRY[name](**kw).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 6, 75, 216)),
        train=False))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
