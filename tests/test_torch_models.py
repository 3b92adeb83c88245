"""The port's SAUnet, its layers, the weight bridge and the window gather
against the JAX package, on the CPU.

The JAX modules are initialised (the SAUnet's variables are the
committed protocol golden's), every norm and BatchNorm leaf is then
replaced by seeded random values (so a layout mistake cannot hide behind
ones and zeros), and the same variables reach the port through
``state_dict_from_flax``. Layers and the model are held to atol 2e-4,
rtol 1e-2, as tests/test_unets.py holds the JAX package to the
reference: flax's LayerNorm computes the variance as E[x²] - E[x]², and
convolutions sum in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch import nn

from multipitch_architectures_tpu.data import windows as jwin
from multipitch_architectures_tpu.experiments import (
    load_experiment as j_load_experiment)
from multipitch_architectures_tpu.models import layers as jl
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu.models.port import export_state_dict
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.data import (gather_windows,
                                                     window_centers)
from multipitch_architectures_tpu_torch.experiments import (build_model,
                                                            load_experiment)
from multipitch_architectures_tpu_torch.models import (
    DoubleConv, HarmonicLayerNorm, SimpleUNetDoubleSelfAttn,
    TransformerEncLayer, init_parameters, max_pool2d, pitch_head,
    state_dict_from_flax)

TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=16,
            embed_dim=32, num_heads=8, mlp_dim=64, pos_encoding="sinusoidal")
ATOL, RTOL = 2e-4, 1e-2
EXP180E = "exp180e_musicnet_unet_insanelylarge_doubleselfattn"


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomised(variables, seed):
    """numpy copy of flax variables with seeded random norm/BN leaves."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "mean" or (name == "bias" and "ln" in str(path)):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _init(module, x, seed=0, **kw):
    return _randomised(module.init({"params": jax.random.PRNGKey(seed)},
                                   jnp.asarray(x), **kw), seed)


@pytest.fixture(scope="module")
def saunet_variables():
    """Tiny-SAUnet variables from the committed protocol golden (exact
    msgpack, so no JAX init is traced), with random norm/BN leaves."""
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "predict_framewise_golden.npz"))
    return _randomised(serialization.msgpack_restore(
        g["variables_msgpack"].tobytes()), 3)


def _sub_state_dict(params, stats, name, convdrop=0.0):
    """The port's state_dict of one module, from its flax variables."""
    sd = state_dict_from_flax({"params": {name: params},
                               "batch_stats": {name: stats}}, convdrop)
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_harmonic_layer_norm_matches_jax():
    x = np.random.RandomState(0).rand(2, 9, 216, 6).astype(np.float32)
    jm = jl.HarmonicLayerNorm()
    v = _init(jm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = HarmonicLayerNorm(6, 216)
    tm.load_state_dict({"weight": torch.from_numpy(v["params"]["ln"]["scale"].T),
                        "bias": torch.from_numpy(v["params"]["ln"]["bias"].T)})
    with torch.no_grad():
        got = tm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("convdrop", [0.0, None])
def test_double_conv_matches_jax(convdrop):
    """Both Sequential layouts: convs at 0 and 4 with a convdrop number
    (0.0 included), at 0 and 3 with None."""
    x = np.random.RandomState(1).rand(2, 12, 20, 5).astype(np.float32)
    jm = jl.DoubleConv(7, 6, (5, 5), (2, 2), convdrop=convdrop)
    v = _init(jm, x, train=False)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = DoubleConv(5, 7, 6, (5, 5), (2, 2), convdrop=convdrop).eval()
    tm.load_state_dict(_sub_state_dict(v["params"], v["batch_stats"], "inc",
                                       convdrop), strict=True)
    conv2 = 4 if convdrop is not None else 3
    assert isinstance(tm.double_conv[conv2], nn.Conv2d)
    with torch.no_grad():
        got = tm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pe,mode", [("sinusoidal", "cross_batch"),
                                     (None, "cross_batch:2"),
                                     (None, "tokens")])
def test_transformer_layer_matches_jax(pe, mode):
    """The bottleneck layer on a 4 x 13 map (52 tokens, as at 75 x 216)."""
    x = np.random.RandomState(2).randn(4, 4, 13, 32).astype(np.float32)
    jm = jl.TransformerEncLayer(32, 8, 64, pos_encoding=pe, attn_mode=mode)
    v = _init(jm, x, train=False)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = TransformerEncLayer(32, 8, 64, pos_encoding=pe, attn_mode=mode).eval()
    tm.load_state_dict(_sub_state_dict(v["params"], {}, "attention1"),
                       strict=True)
    with torch.no_grad():
        got = tm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_pitch_head_and_max_pool_match_jax():
    x = np.random.RandomState(3).rand(2, 75, 216, 8).astype(np.float32)
    jm = jl.PitchHead((8, 8, 4, 2))
    v = _init(jm, x, train=False)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = nn.ModuleDict(pitch_head(8, (8, 8, 4, 2))).eval()
    # the reference keeps the head's convs at the model's top level
    tm.load_state_dict(state_dict_from_flax({"params": {"head": v["params"]}}),
                       strict=True)
    with torch.no_grad():
        got = tm.conv4(tm.conv3(tm.conv2(_nchw(x))))
    assert got.shape == (2, 1, 1, 72)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(
        max_pool2d(_nchw(x), (13, 1), (1, 1), (6, 0)).numpy(),
        np.asarray(jl.max_pool2d(jnp.asarray(x), (13, 1), (1, 1), (6, 0)))
        .transpose(0, 3, 1, 2))


def test_saunet_matches_jax_forward(saunet_variables):
    """SAUnet at tiny geometry, three windows, cross-batch attention."""
    x = np.random.RandomState(4).rand(3, 6, 75, 216).astype(np.float32)
    jm = ju.SimpleUNetDoubleSelfAttn(**TINY)
    v = saunet_variables
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = SimpleUNetDoubleSelfAttn(**TINY).eval()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1, 1, 72)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("convdrop", [0.0, None])
def test_state_dict_from_flax_equals_export_state_dict(saunet_variables,
                                                      convdrop):
    """Key for key and value for value the JAX package's exporter, and
    ``load_state_dict(strict=True)`` takes it."""
    v = saunet_variables
    ours = state_dict_from_flax(v, convdrop)
    theirs = export_state_dict(v, convdrop=convdrop)
    assert sorted(ours) == sorted(theirs)
    for k, t in ours.items():
        np.testing.assert_array_equal(t.numpy(), theirs[k], err_msg=k)
    tm = SimpleUNetDoubleSelfAttn(**TINY, convdrop=convdrop)
    tm.load_state_dict(ours, strict=True)


def test_exp180e_builds_at_full_width_with_the_jax_geometry():
    """exp180e from the registry: every state_dict key and shape equals
    the JAX package's exported model at full width (traced abstractly,
    nothing computed), and seeded init is reproducible."""
    tm = load_experiment(EXP180E).build_model(attn_mode="cross_batch:50")
    jm = j_load_experiment(EXP180E).build_model()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 6, 75, 216)),
        train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {k: np.shape(a) for k, a in export_state_dict(zeros).items()}
    assert {k: tuple(t.shape) for k, t in tm.state_dict().items()} == want
    assert tm.attention1.attn.mode == tm.attention2.attn.mode == \
        "cross_batch:50"
    assert (tm.attention1.pos_encoding, tm.attention2.pos_encoding) == \
        ("sinusoidal", None)

    small = [build_model("simple_u_net_doubleselfattn", TINY)
             for _ in range(3)]
    for m, seed in zip(small, (7, 7, 8)):
        init_parameters(m, torch.Generator().manual_seed(seed))
    a, b, c = (m.state_dict() for m in small)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["inc.double_conv.0.weight"],
                           c["inc.double_conv.0.weight"])
    # every class of the zoo builds; an unknown class raises
    assert type(build_model("freq_u_net", {})).__name__ == "FreqUNet"
    with pytest.raises(KeyError, match="unknown model class"):
        build_model("no_such_model", {})


def test_gather_windows_matches_jax_and_rejects_out_of_range():
    """``lax.dynamic_slice`` clamps a start that is out of range; the port
    raises instead."""
    x = np.random.RandomState(5).rand(6, 100, 216).astype(np.float32)
    centers = np.array([37, 40, 62])
    got = gather_windows(torch.from_numpy(x), centers, 75)
    want = np.asarray(jwin.gather_windows(jnp.asarray(x), centers, 75))
    assert got.shape == (3, 6, 75, 216)
    np.testing.assert_array_equal(got.numpy(), want)
    for bad in ([36], [63]):
        with pytest.raises(ValueError, match="windows span"):
            gather_windows(torch.from_numpy(x), np.array(bad), 75)
    np.testing.assert_array_equal(window_centers(500, 75, 1, offset=3),
                                  jwin.window_centers(500, 75, 1, offset=3))
