"""The port's serving artifacts (``serve.py``) and export CLI
(``experiments/export.py``) on the CPU: the round trip and its header, a
headerless blob, the tail policy of each ``batch_mode`` (as
tests/test_serve.py holds the JAX package's), whole recordings against
``predict_framewise``, the int8 GEMM as one operator node of an int8
artifact (bit-equal to the eager quantized forward), the port's float32
artifact against the JAX package's artifact of the same weights, and the
CLI."""

import io
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo import seeded_variables

from multipitch_architectures_tpu import serve as jserve
from multipitch_architectures_tpu.models import cnns as jc
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.eval import (
    calibrate_activation_scales, eligible_convs, predict_framewise,
    quantize_convs)
from multipitch_architectures_tpu_torch.experiments import export as cli
from multipitch_architectures_tpu_torch.serve import (
    _MAGIC, export_window_forward, load_window_forward,
    predict_framewise_exported)
from multipitch_architectures_tpu_torch.utils import counters

TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72)
TINY_ATTN = dict(TINY, scalefac=16, embed_dim=32, num_heads=8, mlp_dim=64,
                 pos_encoding="sinusoidal")
EXPORT_TOL = 1e-5     # the artifact against eager, and against JAX's: 1e-4


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cnn(seed=0):
    model = tmodels.BasicCnnSegmSigmoid(**TINY).eval()
    tmodels.init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _windows(n, seed):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        n, 6, 75, 216).astype(np.float32))


def test_export_roundtrip_and_header(tmp_path):
    """The artifact reproduces the model; its header carries the batch
    contract, the shapes, the devices and the caller's fields; a device
    it does not list is refused; a headerless blob loads as
    ``independent``."""
    model = _cnn()
    blob = export_window_forward(model, batch_size=4, batch_mode="grouped:2",
                                 meta={"model": "basic_cnn_segm_sigmoid"})
    assert blob[:len(_MAGIC)] == _MAGIC
    (tmp_path / "a.mptpu").write_bytes(blob)
    fn = load_window_forward((tmp_path / "a.mptpu").read_bytes(),
                             device="cpu")
    assert fn.meta == dict(model="basic_cnn_segm_sigmoid",
                           batch_mode="grouped:2", batch_size=4, context=75,
                           n_harmonics=6, n_bins_in=216, int8=False,
                           devices=["cpu"])
    x = _windows(4, 0)
    with torch.no_grad():
        want = model(x).reshape(4, -1)
    np.testing.assert_allclose(fn(x).numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="devices"):
        load_window_forward(blob, device="meta")

    n = struct.unpack("<I", blob[len(_MAGIC):len(_MAGIC) + 4])[0]
    legacy = load_window_forward(blob[len(_MAGIC) + 4 + n:], device="cpu")
    assert legacy.meta == {}
    np.testing.assert_array_equal(legacy(x).numpy(), fn(x).numpy())

    with pytest.raises(ValueError, match="batch_mode"):
        export_window_forward(model, batch_size=4, batch_mode="bogus")
    with pytest.raises(ValueError, match="multiple"):
        export_window_forward(model, batch_size=4, batch_mode="grouped:3")
    with pytest.raises(ValueError, match="eval"):
        export_window_forward(_cnn().train(), batch_size=4)


def test_exported_tail_policy_by_batch_mode():
    """Duplicate-padded tails: silent for independent exports, a warning
    for grouped exports only where the tail breaks a group, a warning or
    a refusal for plain cross-batch ones (tests/test_serve.py:151)."""
    blob = export_window_forward(_cnn(), batch_size=4)
    fn = load_window_forward(blob, device="cpu")
    inputs = torch.from_numpy(np.random.RandomState(1).rand(
        6, 10, 216).astype(np.float32))
    inputs11 = torch.from_numpy(np.random.RandomState(2).rand(
        6, 11, 216).astype(np.float32))

    with warnings.catch_warnings():
        warnings.simplefilter("error")             # independent: silent
        ind = predict_framewise_exported(fn, inputs, batch_size=4)
        # grouped:2, tail 10 % 4 = 2: one full group, exact and silent
        predict_framewise_exported(fn, inputs, batch_size=4,
                                   batch_mode="grouped:2")
    assert ind.shape == (10, 72)
    with pytest.warns(UserWarning, match="last 1 frames"):
        predict_framewise_exported(fn, inputs11, batch_size=4,
                                   batch_mode="grouped:2")
    with pytest.raises(ValueError, match="last 1 frames"):
        predict_framewise_exported(fn, inputs11, batch_size=4,
                                   batch_mode="grouped:2", strict=True)
    with pytest.warns(UserWarning, match="last 2 frames"):
        predict_framewise_exported(fn, inputs, batch_size=4,
                                   batch_mode="cross_batch")


@pytest.mark.parametrize("case", ["independent", "grouped"])
def test_exported_framewise_matches_predict_framewise(case):
    """Whole recordings through the artifact: every frame of an
    independent export; every frame but the last partial group of a
    ``grouped:5`` export at batch 10 (28 frames: 10, 10, and a tail of 8
    padded to 10, whose last 3 frames see duplicates)."""
    if case == "independent":
        model, group, t, mode = _cnn(), None, 21, "independent"
    else:
        model = tmodels.SimpleUNetDoubleSelfAttn(
            **TINY_ATTN, attn_mode="cross_batch:5").eval()
        tmodels.init_parameters(model, torch.Generator().manual_seed(1))
        group, t, mode = 5, 28, "grouped:5"
    fn = load_window_forward(export_window_forward(
        model, batch_size=10 if group else 8, batch_mode=mode), device="cpu")
    inputs = torch.from_numpy(np.random.RandomState(3).rand(
        6, t, 216).astype(np.float32))
    want = predict_framewise(model, inputs, batch_size=fn.meta["batch_size"],
                             group=group)
    exact = t - (t % 10) % 5 if group else t
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = predict_framewise_exported(fn, inputs,
                                         batch_size=fn.meta["batch_size"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:exact].numpy(), want[:exact].numpy(),
                               atol=EXPORT_TOL, rtol=0)
    if group:
        assert float((got[exact:] - want[exact:]).abs().max()) > 0


def test_int8_artifact_runs_the_int8_gemm_operator():
    """An int8 artifact holds one node of the int8 GEMM's operator per
    quantized conv, loads with no model code, and is bit-equal to the
    eager ``quantize_convs`` forward; its header says int8."""
    model = tmodels.SimpleUNetDoubleSelfAttn(
        **TINY_ATTN, attn_mode="cross_batch:5").eval()
    tmodels.init_parameters(model, torch.Generator().manual_seed(2))
    x = torch.log1p(10 * _windows(10, 4))
    q = quantize_convs(model, min_kernel_elems=1024,
                       activation_scales=calibrate_activation_scales(
                           model, [x], 1024))
    fn = load_window_forward(export_window_forward(
        q, batch_size=10, batch_mode="grouped:5"), device="cpu")
    assert fn.meta["int8"] is True
    nodes = [n for n in fn.program.graph.nodes if n.op == "call_function"
             and "mpt_torch.int8_conv2d_dequant" in str(n.target)]
    assert len(nodes) == len(eligible_convs(model, 1024)) > 10
    before = counters["int8.conv_dequant_launches"]
    with torch.no_grad():
        want = q(x).reshape(10, -1)
    np.testing.assert_array_equal(fn(x).numpy(), want.numpy())
    assert counters["int8.conv_dequant_launches"] == before  # the CPU: none


def test_float32_artifact_matches_the_jax_artifact():
    """The port's artifact and the JAX package's, of the same weights, on
    the same windows (1e-4)."""
    jm = jc.BasicCnnSegmSigmoid(**TINY)
    v = seeded_variables(jm, np.zeros((1, 6, 75, 216), np.float32), 5,
                         train=False)
    jfn = jserve.load_window_forward(jserve.export_window_forward(
        lambda variables, x: jm.apply(variables, x, train=False), v,
        batch_size=4))
    tm = tmodels.BasicCnnSegmSigmoid(**TINY).eval()
    tm.load_state_dict(tmodels.state_dict_from_flax(v), strict=True)
    fn = load_window_forward(export_window_forward(tm, batch_size=4),
                             device="cpu")
    x = np.random.RandomState(6).rand(4, 6, 75, 216).astype(np.float32)
    want = np.asarray(jfn(x))
    assert float(want.std()) > 1e-2
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                               atol=1e-4, rtol=0)


CNN_ARGS = ["--model", "basic_cnn_segm_sigmoid", "--model-args",
            '{"n_chan_layers": [8, 8, 4, 2], "n_bins_out": 72}',
            "--batch-size", "4", "--device", "cpu"]


def test_export_cli_export_then_predict(tmp_path):
    """export, then predict with no model code, at tiny width; the
    prediction is the artifact's."""
    hcqt = np.random.RandomState(3).rand(216, 9, 6).astype(np.float32)
    np.save(tmp_path / "h.npy", hcqt)             # the reference's layout
    art, out = tmp_path / "a.mptpu", tmp_path / "p.npy"
    assert cli.main(["export", *CNN_ARGS, "--out", str(art)]) == 0
    assert cli.main(["predict", "--artifact", str(art), "--hcqt",
                     str(tmp_path / "h.npy"), "--device", "cpu", "--out",
                     str(out)]) == 0
    fn = load_window_forward(art.read_bytes(), device="cpu")
    assert fn.meta["model"] == "basic_cnn_segm_sigmoid"
    want = predict_framewise_exported(
        fn, torch.from_numpy(hcqt.transpose(2, 1, 0).copy()), batch_size=4)
    np.testing.assert_array_equal(np.load(out), want.numpy())


def test_export_cli_int8_gate(tmp_path, capsys):
    """--int8 verifies the drift on the whole protocol span of
    --calibrate-hcqt and refuses above the gate; --int8-hybrid demotes
    convs until it passes; --allow-drift exports anyway."""
    np.save(tmp_path / "h.npy", np.random.RandomState(3).rand(
        6, 20, 216).astype(np.float32))
    out = tmp_path / "b.mptpu"
    args = ["export", *CNN_ARGS, "--out", str(out), "--int8",
            "--calibrate-hcqt", str(tmp_path / "h.npy")]
    with pytest.raises(SystemExit, match="REFUSED"):
        cli.main(args + ["--drift-gate", "1e-15"])
    assert not out.exists()
    assert "drift on verification windows" in capsys.readouterr().out
    cli.main(args + ["--drift-gate", "1e-15", "--int8-hybrid"])
    assert "hybrid policy" in capsys.readouterr().out
    assert load_window_forward(out.read_bytes(),
                               device="cpu").meta["batch_mode"] == \
        "independent"
    out.unlink()
    cli.main(args + ["--drift-gate", "1e-15", "--allow-drift",
                     "--calibrate-percentile", "99.9"])
    assert load_window_forward(out.read_bytes(), device="cpu").meta["int8"]
