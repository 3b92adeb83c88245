"""The port's model zoo against the JAX package, on the CPU: the six
classes that the registry uses besides the SAUnet (CNN, DCNN/DRCNN,
Unet, SAUSnet, BLUnet, PUnet), their new layers, the weight bridge, the
matmul-form upsampling and the logged full-width parameter counts.

The JAX variables are shaped by ``jax.eval_shape`` (no init is traced)
and filled from a numpy seed: weights at a sqrt(gain/fan-in) scale, every
bias, norm and BatchNorm statistic random, so that no layout mistake
hides behind ones and zeros. The same variables reach the port through
``state_dict_from_flax``. Forwards in eval mode are held to atol 2e-4,
rtol 1e-2, as tests/test_torch_models.py holds the SAUnet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.models import cnns as jc
from multipitch_architectures_tpu.models import layers as jl
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu.models.port import export_state_dict
from multipitch_architectures_tpu.ops import resize as jresize
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch.experiments import (build_model,
                                                            load_experiment)
from multipitch_architectures_tpu_torch.models import (
    BLSTMTemporalEncLayer, DoubleConv, PitchHead, state_dict_from_flax)
from multipitch_architectures_tpu_torch.ops import (
    TorchLSTM, upsample_bilinear_align_corners)

ATOL, RTOL = 2e-4, 1e-2
TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72)
TINY_UNET = dict(TINY, scalefac=16)
TINY_ATTN = dict(TINY_UNET, embed_dim=32, num_heads=8, mlp_dim=64,
                 pos_encoding="sinusoidal")

# name -> (JAX class, port class, kwargs, windows in the batch); the
# weights' gain is 2 (He), less where residual sums grow the activations
# until the sigmoid saturates
CASES = {
    "cnn": (jc.BasicCnnSegmSigmoid, tmodels.BasicCnnSegmSigmoid, TINY, 2),
    "dcnn": (jc.DeepCnnSegmSigmoid, tmodels.DeepCnnSegmSigmoid,
             dict(TINY, n_prefilt_layers=3, residual=False), 2),
    "drcnn": (jc.DeepCnnSegmSigmoid, tmodels.DeepCnnSegmSigmoid,
              dict(TINY, n_prefilt_layers=3, residual=True), 2, 0.5),
    "unet": (ju.SimpleUNetLargeKernels, tmodels.SimpleUNetLargeKernels,
             TINY_UNET, 2),
    "sausnet": (ju.SimpleUNetDoubleSelfAttnTwoLayers,
                tmodels.SimpleUNetDoubleSelfAttnTwoLayers, TINY_ATTN, 3),
    "sausnet_residual": (ju.SimpleUNetDoubleSelfAttnTwoLayers,
                         tmodels.SimpleUNetDoubleSelfAttnTwoLayers,
                         dict(TINY_ATTN, residual=True,
                              attn_mode="cross_batch:2"), 4, 1.0),
    # the registry's BLUnet geometry at scalefac 16: 32 channels x 13 bins
    # at level 5, 2 x 208 LSTM features
    "blunet_depth1": (ju.UNetBlstmVarLayers, tmodels.UNetBlstmVarLayers,
                      dict(TINY_UNET, embed_dim=416, hidden_size=208,
                           lstm_depth=1, lstm_number=2), 2),
    # depth 2: 2H must split onto 13 and onto 27 bins (702 = 2 x 351),
    # which changes both levels' channels, as in the JAX package
    "blunet_depth2": (ju.UNetBlstmVarLayers, tmodels.UNetBlstmVarLayers,
                      dict(TINY_UNET, embed_dim=416, hidden_size=351,
                           lstm_depth=2, lstm_number=1), 2),
    "punet": (ju.SimpleUNetPolyphonyClassifSoftmax,
              tmodels.SimpleUNetPolyphonyClassifSoftmax,
              dict(TINY_UNET, num_polyphony_steps=24), 2),
}

# the registry's full-width configurations and their logged parameter
# counts (tests/test_cnns.py, tests/test_unets.py); the SAUSnet's log
# misses its four attention cores' 66,048 parameters each, and the
# Unet:XL count is the JAX model's (test_unet_xl_count_is_the_jax_models)
MHA_128 = 4 * 128 * 128 + 4 * 128
UNET_XL = 14_251_699
FULL_WIDTH = {
    "exp126c_musicnet_cnn_verywide": 1_813_293,
    "exp128c_musicnet_cnn_deepresnetverywide": 4_814_683,
    "exp160f_musicnet_unet_veryverylarge": UNET_XL,
    "exp181f_musicnet_unet_intermedlarge_doubleselfattn_twolayers":
        14_435_647 + 4 * MHA_128,
    "exp186d_musicnet_unet_extremelylarge_blstm": 9_649_003,
    "exp195f_musicnet_unet_extremelylarge_polyphony_softmax": 14_597_963,
}


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(module, x, seed, gain=2.0, **kw):
    """flax variables of ``module`` for input ``x``, shaped abstractly and
    filled from numpy seed ``seed``; conv and dense kernels with variance
    ``gain / fan_in``."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), **kw))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(gain / fan_in)
        elif name.startswith(("weight_", "bias_")):        # LSTM
            bound = 1.0 / np.sqrt(shape[0] // 4)
            v = rng.uniform(-bound, bound, shape)
        elif name.endswith("proj_weight"):                 # attention
            v = rng.randn(*shape) / np.sqrt(shape[-1])
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:                                              # biases, means
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _sub_state_dict(params, stats, name):
    sd = state_dict_from_flax({"params": {name: params},
                               "batch_stats": {name: stats}})
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_matches_jax_forward(name):
    """Each class at a small width, windows of 75 x 216, eval mode: every
    output (the PUnet's polyphony logits included) within 2e-4 of the JAX
    forward; the bridged weights load strictly and are the JAX
    exporter's, key for key and value for value."""
    jcls, tcls, kw, n, *gain = CASES[name]
    x = np.random.RandomState(4).rand(n, 6, 75, 216).astype(np.float32)
    jm = jcls(**kw)
    v = seeded_variables(jm, x, sorted(CASES).index(name), *gain,
                         train=False)
    want = jm.apply(v, jnp.asarray(x), train=False)
    want = want if isinstance(want, tuple) else (want,)

    sd = state_dict_from_flax(v)
    theirs = export_state_dict(v)
    assert sorted(sd) == sorted(theirs)
    for k, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), theirs[k], err_msg=k)
    tm = tcls(**kw).eval()
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    assert got[0].shape == (n, 1, 1, 72)
    if name == "punet":
        assert got[1].shape == (n, 24, 1, 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(w.std()) > 1e-2          # not saturated, not constant
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


def test_double_conv_residual_matches_jax():
    """The 1x1 ``resize`` shortcut, under the reference's key."""
    x = np.random.RandomState(1).rand(2, 12, 20, 5).astype(np.float32)
    jm = jl.DoubleConv(7, 6, (5, 5), (2, 2), residual=True)
    v = seeded_variables(jm, x, 0, train=False)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = DoubleConv(5, 7, 6, (5, 5), (2, 2), residual=True).eval()
    sd = _sub_state_dict(v["params"], v["batch_stats"], "down1")
    assert "1.resize.weight" in sd
    tm.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_blstm_layer_matches_jax(num_layers):
    """The channel-major flattening: NHWC (B, T, F, C) there, NCHW
    (B, C, T, F) here; the output split back as (B, 2H/F, T, F)."""
    b, t, f, c, hidden = 2, 4, 13, 6, 39
    x = np.random.RandomState(2).randn(b, t, f, c).astype(np.float32)
    jm = jl.BLSTMTemporalEncLayer(f * c, hidden, num_layers)
    v = seeded_variables(jm, x, 1)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = BLSTMTemporalEncLayer(c, f, hidden, num_layers)
    assert isinstance(tm.blstm, TorchLSTM) and tm.blstm.batch_first
    tm.load_state_dict(_sub_state_dict(v["params"], {}, "lstm5"),
                       strict=True)
    with torch.no_grad():
        got = tm(_nchw(x))
    assert got.shape == (b, 2 * hidden // f, t, f)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="does not split"):
        BLSTMTemporalEncLayer(c, f, 40)


def test_pitch_head_module_is_the_models_head():
    """``PitchHead`` applied as one module equals the three parts that a
    model holds at its top level."""
    head = PitchHead(8, (8, 8, 4, 2)).eval()
    model = tmodels.BasicCnnSegmSigmoid(**TINY).eval()
    head.load_state_dict({k: v for k, v in model.state_dict().items()
                          if k.startswith(("conv2", "conv3", "conv4"))},
                         strict=True)
    x = torch.rand(2, 8, 75, 216)
    with torch.no_grad():
        torch.testing.assert_close(head(x), model.conv4(model.conv3(
            model.conv2(x))), rtol=0, atol=0)
    assert not any(k.startswith("_") for k in model.state_dict())


@pytest.mark.parametrize("h_in,w_in,h_out,w_out", [
    (4, 13, 8, 26), (37, 108, 74, 216), (1, 5, 2, 10), (9, 27, 18, 54)])
def test_upsample_bilinear_align_corners_matches_jax(h_in, w_in, h_out,
                                                     w_out):
    """The matmul form against the JAX package's within 1e-6, and against
    ``F.interpolate`` (the reference's op, float32 sampling positions)
    within 1e-4."""
    x = np.random.RandomState(5).randn(2, 3, h_in, w_in).astype(np.float32)
    got = upsample_bilinear_align_corners(torch.from_numpy(x),
                                          (h_out, w_out))
    want = np.asarray(jresize.upsample_bilinear_align_corners(
        jnp.asarray(x.transpose(0, 2, 3, 1)), (h_out, w_out)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-6)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(h_out, w_out), mode="bilinear",
        align_corners=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)
    # float64 in, float64 operators: no float32 step
    got64 = upsample_bilinear_align_corners(torch.from_numpy(x).double(),
                                            (h_out, w_out))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_parameter_counts(name):
    """Each registry configuration of the zoo phase, built on the meta
    device through ``load_experiment``, has its logged parameter count;
    no JAX needed."""
    with torch.device("meta"):
        model = load_experiment(name).build_model()
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH[name]


def test_unet_xl_count_is_the_jax_models():
    """The Unet:XL constant above is the JAX model's count (traced
    abstractly, nothing computed), and the port's full-width keys and
    shapes are the JAX exporter's."""
    from multipitch_architectures_tpu.experiments import (
        load_experiment as j_load_experiment)

    name = "exp160f_musicnet_unet_veryverylarge"
    jm = j_load_experiment(name).build_model()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 6, 75, 216)),
        train=False))
    assert sum(int(np.prod(s.shape))
               for s in jax.tree.leaves(shapes["params"])) == UNET_XL
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {k: np.shape(a) for k, a in export_state_dict(zeros).items()}
    with torch.device("meta"):
        tm = load_experiment(name).build_model()
    assert {k: tuple(t.shape) for k, t in tm.state_dict().items()} == want


def test_build_model_keeps_residual():
    """The DRCNN's ``residual`` reaches the class (it adds no parameter,
    so only the forward tells DRCNN from DCNN)."""
    kw = dict(load_experiment(
        "exp128c_musicnet_cnn_deepresnetverywide").model_kwargs)
    assert kw["residual"] is True
    assert build_model("deep_cnn_segm_sigmoid", kw).residual is True
    kw["residual"] = False
    assert build_model("deep_cnn_segm_sigmoid", kw).residual is False
