"""The port's frequency and temporal U-Nets against the JAX package, on
the CPU: the four freq U-Nets and the two temporal U-Nets at the JAX
tests' geometries (tests/test_unets.py:100-190), their new layers (the
frequency max-pool with window-local indices and its unpool; the
temporal transformer layer); one train step of ``FreqUNetSelfAttn`` is
in tests/test_torch_zoo_freq_train.py.

The JAX variables are filled from a numpy seed as in
tests/test_torch_zoo.py and bridged by ``state_dict_from_flax``; eval
forwards are held to atol 2e-4, rtol 1e-2, the layers to 1e-5. The
reverse porters ``port_freq_u_net_selfattn`` and ``port_unet_auto`` give
back the flax variables from the port's ``state_dict`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.models import layers as jl
from multipitch_architectures_tpu.models import port as jport
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch.models import (
    TransformerTemporalEncLayer, max_pool_with_indices_freq, max_unpool_freq)

from test_torch_zoo import ATOL, RTOL, _parity_settings  # noqa: F401
from test_torch_zoo import _sub_state_dict, seeded_variables
from test_torch_zoo_unets import assert_trees_equal, jax_pair

FREQ = dict(n_chan_layers=(32, 8, 4, 2), n_bins_out=72, scalefac=2)
FREQ_ATTN = dict(FREQ, embed_dim=32, num_heads=8, mlp_dim=64)
TEMPORAL = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=2)

# name -> (JAX class, port class, kwargs, windows, reverse porter or None)
CASES = {
    "freq_u_net": (ju.FreqUNet, tmodels.FreqUNet, FREQ, 2, None),
    "freq_bottomstack": (ju.FreqUNetBottomStack, tmodels.FreqUNetBottomStack,
                         FREQ, 2, None),
    "freq_selfattn": (ju.FreqUNetSelfAttn, tmodels.FreqUNetSelfAttn,
                      FREQ_ATTN, 3, jport.port_freq_u_net_selfattn),
    "freq_doubleselfattn": (
        ju.FreqUNetDoubleSelfAttn, tmodels.FreqUNetDoubleSelfAttn, FREQ_ATTN,
        3, lambda sd: jport.port_freq_u_net_selfattn(sd, double=True)),
    "temporal_selfattn": (
        ju.UNetTemporalSelfAttnVarLayers,
        tmodels.UNetTemporalSelfAttnVarLayers,
        dict(TEMPORAL, embed_dim=1728, num_heads=8, mlp_dim=64,
             self_attn_depth=1, self_attn_number=2,
             pos_encoding="sinusoidal"), 2, jport.port_unet_auto),
    "temporal_blstm": (
        ju.UNetTemporalBlstmVarLayers, tmodels.UNetTemporalBlstmVarLayers,
        dict(TEMPORAL, embed_dim=1728, hidden_size=864, lstm_depth=1,
             lstm_number=1), 2, jport.port_unet_auto),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_freq_and_temporal_unets_match_jax_forward(name):
    jcls, tcls, kw, n, porter = CASES[name]
    x, v, want, tm = jax_pair(jcls, tcls, kw, n, sorted(CASES).index(name))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    bins = 73 if name == "freq_bottomstack" else 72
    assert got.shape == want[0].shape == (n, 1, 1, bins)
    assert float(want[0].std()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want[0], atol=ATOL, rtol=RTOL)
    if porter is not None:
        assert_trees_equal(porter(tm.state_dict()), v)


def test_freq_pool_and_unpool_match_jax_with_ties():
    """Values and window-local indices of the first maximum equal the
    JAX package's on a map with deliberate ties (quantized values), and
    the unpool puts each value back at its index."""
    rng = np.random.RandomState(0)
    x = (rng.randint(0, 3, (2, 5, 7, 72)) / 2).astype(np.float32)  # NCHW
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))                        # NHWC
    for k in (3, 4, 8, 9):
        pooled, idx = max_pool_with_indices_freq(torch.from_numpy(x), k)
        jp, ji = jl.max_pool_with_indices_freq(xj, k)
        np.testing.assert_array_equal(pooled.numpy(),
                                      np.asarray(jp).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(idx.numpy(),
                                      np.asarray(ji).transpose(0, 3, 1, 2))
        up = max_unpool_freq(pooled, idx, k)
        ju_ = jl.max_unpool_freq(jp, ji, k)
        np.testing.assert_array_equal(up.numpy(),
                                      np.asarray(ju_).transpose(0, 3, 1, 2))
    with pytest.raises(ValueError, match="pool by 5"):
        max_pool_with_indices_freq(torch.from_numpy(x), 5)


@pytest.mark.parametrize("pos_encoding", ["sinusoidal", "learnable"])
def test_temporal_layer_matches_jax(pos_encoding):
    """``TransformerTemporalEncLayer`` alone on a map with C != F (the
    channel-major flattening of each time step's features), 1e-5."""
    b, t, f, c = 4, 9, 5, 6                     # NHWC on the JAX side
    x = np.random.RandomState(3).randn(b, t, f, c).astype(np.float32)
    jm = jl.TransformerTemporalEncLayer(f * c, 2, 16,
                                        pos_encoding=pos_encoding,
                                        attn_mode="cross_batch:2")
    v = seeded_variables(jm, x, 5)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = TransformerTemporalEncLayer(f * c, 2, 16, pos_encoding=pos_encoding,
                                     attn_mode="cross_batch:2").eval()
    tm.load_state_dict(_sub_state_dict(v["params"], {}, "attention_time1"),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-5, rtol=1e-5)
