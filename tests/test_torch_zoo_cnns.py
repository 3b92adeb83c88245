"""The port's other four CNNs against the JAX package, on the CPU
(geometries of the JAX tests, tests/test_cnns.py:95-120), their serving
through ``predict_framewise`` beside the freq U-Net with the bottom
stack, the reverse porters' round trip, and ``torch_module_name`` over
every conv of the new families, held key for key against the bridge.
"""

import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.eval.inference import \
    predict_framewise as j_predict_framewise
from multipitch_architectures_tpu.models import cnns as jc
from multipitch_architectures_tpu.models import port as jport
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch.eval import predict_framewise
from multipitch_architectures_tpu_torch.models import (state_dict_from_flax,
                                                       torch_module_name)

from test_torch_quant import _flax_conv_paths
from test_torch_zoo import ATOL, RTOL, _parity_settings  # noqa: F401
from test_torch_zoo import seeded_variables
from test_torch_zoo_freq import CASES as FREQ_CASES
from test_torch_zoo_unets import (CASES as UNET_CASES, assert_trees_equal,
                                  jax_pair)

KW = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72)


def _port_logsoftmax(sd):
    """The JAX tests' porter of the log-softmax CNN (tests/test_cnns.py:
    104-112): the segmentation trunk, then conv2..conv5 at the top."""
    return {"params": {
        "trunk": jport.port_basic_cnn_segm(sd)["params"]["trunk"],
        "conv2": {"conv": jport._conv(sd, "conv2.0")},
        "conv3": {"conv": jport._conv(sd, "conv3.0")},
        "conv4": {"conv": jport._conv(sd, "conv4.0")},
        "conv5": jport._conv(sd, "conv4.3")}}


# name -> (JAX class, port class, kwargs, output shape of 2 windows,
# reverse porter)
CASES = {
    "basic_cnn": (jc.BasicCnn, tmodels.BasicCnn, KW, (2, 1, 1, 72),
                  jport.port_basic_cnn),
    "basic_cnn_pool": (jc.BasicCnnPool, tmodels.BasicCnnPool, KW,
                       (2, 1, 1, 72), jport.port_basic_cnn),
    "segm_logsoftmax": (jc.BasicCnnSegmLogSoftmax,
                        tmodels.BasicCnnSegmLogSoftmax,
                        dict(KW, n_ch_out=3), (2, 3, 1, 72),
                        _port_logsoftmax),
    "segm_blank_logsoftmax": (jc.BasicCnnSegmBlankLogSoftmax,
                              tmodels.BasicCnnSegmBlankLogSoftmax,
                              dict(KW, n_ch_out=3), (2, 3, 1, 73),
                              jport.port_basic_cnn_segm_blank),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cnn_matches_jax_forward(name):
    """Eval forward within 2e-4 of JAX; the log-softmax heads' channels
    sum to one in probability; the JAX reverse porter gives the flax
    variables back from the port's state_dict exactly."""
    jcls, tcls, kw, shape, porter = CASES[name]
    x, v, want, tm = jax_pair(jcls, tcls, kw, 2, sorted(CASES).index(name))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want[0].shape == shape
    assert float(want[0].std()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want[0], atol=ATOL, rtol=RTOL)
    if "logsoftmax" in name:
        np.testing.assert_allclose(got.exp().sum(1).numpy(), 1.0, atol=1e-5)
    assert_trees_equal(porter(tm.state_dict()), v)


@pytest.mark.parametrize("name", ["segm_blank_logsoftmax",
                                  "freq_bottomstack"])
def test_predict_framewise_matches_jax(name):
    """The windowed protocol over a 1.2-s recording: the same shape as
    the JAX ``predict_framewise`` ((T, 3·73) log-probabilities for the
    blank CNN, (T, 73) for the bottom stack) and the same values."""
    jcls, tcls, kw, _, _ = (CASES[name] if name in CASES
                            else FREQ_CASES[name])
    jm = jcls(**kw)
    _, v, _, tm = jax_pair(jcls, tcls, kw, 1, 3)
    f = np.random.RandomState(5).rand(6, 60, 216).astype(np.float32)
    want = np.asarray(j_predict_framewise(
        lambda var, x: jm.apply(var, x, train=False), v, f, batch_size=16))
    got = predict_framewise(tm, torch.from_numpy(f), batch_size=16)
    assert got.shape == want.shape == (
        (60, 3 * 73) if name in CASES else (60, 73))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# one tiny model of each new family: (JAX class, port class, kwargs,
# torch_module_name's options)
FAMILIES = {
    "basic_cnn": CASES["basic_cnn"][:3] + ({},),
    "segm_logsoftmax": CASES["segm_logsoftmax"][:3] + ({},),
    "segm_blank_logsoftmax": CASES["segm_blank_logsoftmax"][:3] + ({},),
    "simple_u_net": UNET_CASES["simple_u_net"][:3] + ({},),
    "transenc": UNET_CASES["transenc"][:3] + ({},),
    "polyphony_classif": UNET_CASES["polyphony_classif"][:3] + ({},),
    "alt_order": (ju.SimpleUNetDoubleSelfAttn,
                  tmodels.SimpleUNetDoubleSelfAttn,
                  dict(KW, scalefac=16, embed_dim=32, alt_order=True,
                       convdrop=None), {"alt_order": True,
                                        "convdrop": None}),
    "freq_u_net": FREQ_CASES["freq_u_net"][:3] + ({},),
    "freq_bottomstack": FREQ_CASES["freq_bottomstack"][:3] + ({},),
    "freq_doubleselfattn": FREQ_CASES["freq_doubleselfattn"][:3]
    + ({"freq_attn": True},),
    "temporal_selfattn": FREQ_CASES["temporal_selfattn"][:3] + ({},),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_torch_module_name_maps_every_conv_of_the_new_families(name):
    """Each JAX conv path maps to the port's ``nn.Conv2d`` that holds its
    kernel, under the bridge's key; every conv of the port is reached."""
    jcls, tcls, kw, opts = FAMILIES[name]
    v = seeded_variables(jcls(**kw), np.zeros((1, 6, 75, 216), np.float32),
                         0, train=False)
    sd = state_dict_from_flax(v, convdrop=opts.get("convdrop", 0.0),
                              alt_order=opts.get("alt_order", False))
    tm = tcls(**kw)
    tm.load_state_dict(sd, strict=True)
    names = []
    for path, kernel in _flax_conv_paths(v["params"]):
        mod = torch_module_name(path, **opts)
        assert isinstance(tm.get_submodule(mod), torch.nn.Conv2d), path
        np.testing.assert_array_equal(sd[f"{mod}.weight"].numpy(),
                                      kernel.transpose(3, 2, 0, 1),
                                      err_msg=path)
        names.append(mod)
    assert sorted(names) == sorted(
        n for n, m in tm.named_modules() if isinstance(m, torch.nn.Conv2d))
    with pytest.raises(KeyError):
        torch_module_name("attention1/q_linear", **opts)
