"""The port's standard-trunk, varlayers, TransEnc and polyphony U-Nets
against the JAX package, on the CPU, at the JAX tests' small geometries
(tests/test_unets.py:100-190, :282), and the temporal layer's positional table.

The JAX variables are shaped by ``jax.eval_shape`` and filled from a
numpy seed (tests/test_torch_zoo.py's ``seeded_variables``), bridged by
``state_dict_from_flax`` and loaded ``strict=True``. Forwards in eval
mode are held to atol 2e-4, rtol 1e-2, as the zoo's first classes are.
The bridge must hold the reference's key names: the port's
``state_dict``, passed through the JAX package's reverse porter
(``port_unet_auto``, ``port_unet_transenc``), gives back the flax
variables exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from multipitch_architectures_tpu.models import port as jport
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch.models import state_dict_from_flax

from test_torch_zoo import ATOL, RTOL, _parity_settings  # noqa: F401
from test_torch_zoo import seeded_variables

TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=16)
ATTN = dict(embed_dim=32, num_heads=8, mlp_dim=64)
SIN = dict(pos_encoding="sinusoidal")
SC8 = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=8,
           embed_dim=64, num_heads=8, mlp_dim=64)

# name -> (JAX class, port class, kwargs, windows in the batch)
CASES = {
    "simple_u_net": (ju.SimpleUNet, tmodels.SimpleUNet, TINY, 2),
    "selfattn": (ju.SimpleUNetSelfAttn, tmodels.SimpleUNetSelfAttn,
                 dict(TINY, **ATTN), 3),
    "sixselfattn_learnable": (
        ju.SimpleUNetSixSelfAttn, tmodels.SimpleUNetSixSelfAttn,
        dict(TINY, **ATTN, pos_encoding="learnable",
             attn_mode="cross_batch:2"), 4),
    # no positional encoding: level 3 has 18 x 54 = 972 tokens, past the
    # reference's 600-row table (tests/test_unets.py:133)
    "varlayers_depth3": (
        ju.SimpleUNetDoubleSelfAttnVarLayers,
        tmodels.SimpleUNetDoubleSelfAttnVarLayers,
        dict(SC8, self_attn_depth=3, self_attn_number=2), 2),
    "varlayers_depth2_one_sin": (
        ju.SimpleUNetDoubleSelfAttnVarLayers,
        tmodels.SimpleUNetDoubleSelfAttnVarLayers,
        dict(SC8, self_attn_depth=2, self_attn_number=1, **SIN), 2),
    "alllayers": (ju.SimpleUNetDoubleSelfAttnAllLayers,
                  tmodels.SimpleUNetDoubleSelfAttnAllLayers, SC8, 2),
    "transenc": (ju.SimpleUNetDoubleSelfAttnTransEnc,
                 tmodels.SimpleUNetDoubleSelfAttnTransEnc,
                 dict(SC8, n_chan_layers=(8, 4, 4, 2), self_attn_depth=1,
                      self_attn_number=2, time_embed_dim=4 * 72, **SIN), 2),
    "polyphony": (ju.SimpleUNetDoubleSelfAttnPolyphony,
                  tmodels.SimpleUNetDoubleSelfAttnPolyphony,
                  dict(TINY, **ATTN, **SIN), 3),
    "polyphony_classif": (ju.SimpleUNetDoubleSelfAttnPolyphonyClassif,
                          tmodels.SimpleUNetDoubleSelfAttnPolyphonyClassif,
                          dict(TINY, **ATTN, num_polyphony_steps=8), 3),
    "polyphony_plain": (ju.SimpleUNetPolyphonyClassif,
                        tmodels.SimpleUNetPolyphonyClassif,
                        dict(TINY, num_polyphony_steps=8), 2),
}
POLYPHONY = {"polyphony": 1, "polyphony_classif": 8, "polyphony_plain": 8}


def flat(tree):
    return traverse_util.flatten_dict(jax.tree.map(np.asarray, tree),
                                      sep="/")


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def jax_pair(jcls, tcls, kw, n, seed, gain=2.0):
    """(windows, JAX variables, JAX outputs, the port's model with the
    bridged variables); the weights' gain as in ``seeded_variables``."""
    x = np.random.RandomState(4).rand(n, 6, 75, 216).astype(np.float32)
    jm = jcls(**kw)
    v = seeded_variables(jm, x, seed, gain, train=False)
    want = jm.apply(v, jnp.asarray(x), train=False)
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    tm = tcls(**kw).eval()
    tm.load_state_dict(state_dict_from_flax(
        v, convdrop=kw.get("convdrop", 0.0),
        alt_order=kw.get("alt_order", False)), strict=True)
    return x, v, want, tm


@pytest.mark.parametrize("name", sorted(CASES))
def test_unet_matches_jax_forward(name):
    """Each class in eval mode: the salience (and the polyphony head's
    output) within 2e-4 of the JAX forward; the bridged weights load
    strictly; the port's state_dict through the JAX reverse porter is
    the flax variables exactly."""
    jcls, tcls, kw, n = CASES[name]
    x, v, want, tm = jax_pair(jcls, tcls, kw, n, sorted(CASES).index(name))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want) == (2 if name in POLYPHONY else 1)
    assert got[0].shape == (n, 1, 1, 72)
    if name in POLYPHONY:
        assert got[1].shape == (n, POLYPHONY[name], 1, 1)
    for g, w in zip(got, want):
        assert float(w.std()) > 1e-3          # not saturated, not constant
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)

    sd = tm.state_dict()
    learnable = [k.split(".")[0] for k in sd if k.endswith(".pe")]
    porter = (jport.port_unet_transenc if name == "transenc"
              else jport.port_unet_auto)
    assert_trees_equal(porter(sd, learnable_pe=learnable), v)


def test_temporal_positional_table_overflow_raises():
    """The temporal layer's table has 174 rows, as in the JAX package,
    and a longer map raises instead of extending it."""
    layer = tmodels.TransformerTemporalEncLayer(2 * 4, 2, 16,
                                                pos_encoding="sinusoidal")
    layer(torch.rand(1, 2, 174, 4))
    with pytest.raises(ValueError, match="174 rows"):
        layer(torch.rand(1, 2, 175, 4))
    with pytest.raises(ValueError, match="embedding width"):
        layer(torch.rand(1, 3, 10, 4))
