"""DoubleConv's ``alt_order`` in the port against the JAX package, on
the CPU: the pre-activation order ELU-BN-Dropout-Conv, twice, which the
SAUnet's ``alt_order`` selects for every DoubleConv. The model matches
the JAX forward (2e-4), its keys are the JAX exporter's
(``export_state_dict(alt_order=True)``: BNs at 1 and 5, convs at 3 and
7), the JAX reverse porter gives the flax variables back, and a
configuration with ``alt_order: true`` builds the alt-order model.
"""

import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.models import port as jport
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch.models import state_dict_from_flax

from test_torch_zoo import ATOL, RTOL, _parity_settings  # noqa: F401
from test_torch_zoo import seeded_variables
from test_torch_zoo_unets import ATTN, SIN, TINY, assert_trees_equal, \
    jax_pair

# name -> (kwargs, the weights' gain: less where the residual sums grow
# the activations until the sigmoid saturates)
CASES = {
    "alt_order": (dict(TINY, **ATTN, **SIN, alt_order=True), 2.0),
    "alt_order_residual_no_convdrop": (dict(TINY, **ATTN, alt_order=True,
                                            residual=True, convdrop=None),
                                       0.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_alt_order_matches_jax_forward(name):
    kw, gain = CASES[name]
    x, v, want, tm = jax_pair(ju.SimpleUNetDoubleSelfAttn,
                              tmodels.SimpleUNetDoubleSelfAttn, kw, 3,
                              sorted(CASES).index(name), gain)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (3, 1, 1, 72) and float(want[0].std()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want[0], atol=ATOL, rtol=RTOL)
    assert_trees_equal(jport.port_unet_auto(tm.state_dict()), v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_alt_order_keys_are_the_jax_exporters(name):
    """The alt-order layout's keys and values equal JAX
    ``export_state_dict(alt_order=True)``, and the port's model has the
    same keys."""
    kw = CASES[name][0]
    x = np.zeros((1, 6, 75, 216), np.float32)
    v = seeded_variables(ju.SimpleUNetDoubleSelfAttn(**kw), x, 0,
                         train=False)
    sd = state_dict_from_flax(v, convdrop=kw.get("convdrop", 0.0),
                              alt_order=True)
    theirs = jport.export_state_dict(v, convdrop=kw.get("convdrop", 0.0),
                                     alt_order=True)
    tm = tmodels.SimpleUNetDoubleSelfAttn(**kw)
    assert sorted(sd) == sorted(theirs) == sorted(tm.state_dict())
    for k, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), theirs[k], err_msg=k)
    assert "inc.double_conv.7.weight" in sd
    assert "inc.double_conv.0.weight" not in sd
    assert tm.alt_order is True


def test_alt_order_through_build_model():
    """A configuration with ``alt_order: true`` builds the alt-order
    model: ``build_model`` keeps the argument."""
    from multipitch_architectures_tpu_torch.experiments import build_model

    model = build_model("simple_u_net_doubleselfattn",
                        dict(TINY, **ATTN, alt_order=True))
    assert model.alt_order is True
    assert isinstance(model.inc.double_conv[0], torch.nn.ELU)
    assert isinstance(model.down1[1].double_conv[7], torch.nn.Conv2d)
