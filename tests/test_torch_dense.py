"""The port's serving entry points for the rest of the zoo against the
JAX package, on the CPU: dense and chunked-dense serving of the CNN
family, the PUnet's polyphony output through ``predict_framewise(
return_aux=True)``, and ``run_experiment`` end to end on a PUnet and a
CNN entry. The models are tiny, with seeded weights bridged from the
JAX variables (tests/test_torch_zoo.py); float32 outputs within 2e-4.
"""

import dataclasses
import logging
import math
import os

import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.eval import inference as jinf
from multipitch_architectures_tpu.models import cnns as jc
from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.eval import (predict_dense,
                                                     predict_dense_chunked,
                                                     predict_framewise)
from multipitch_architectures_tpu_torch.experiments import (
    SyntheticCorpus, load_experiment, run_experiment, shrink_for_smoke)
from multipitch_architectures_tpu_torch.models import (
    BasicCnnSegmSigmoid, SimpleUNetPolyphonyClassifSoftmax,
    state_dict_from_flax)
from test_torch_zoo import seeded_variables

ATOL = 2e-4
CNN = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72)
PUNET = dict(CNN, scalefac=16, num_polyphony_steps=24)


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    """float32 without TF32, one torch thread (see test_torch_ops.py)."""
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(jcls, tcls, kw, seed):
    """(JAX model, its seeded variables, the port's model with them)."""
    jm = jcls(**kw)
    v = seeded_variables(jm, np.zeros((1, 6, 75, 216), np.float32), seed,
                         train=False)
    tm = tcls(**kw).eval()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, tm


@pytest.fixture(scope="module")
def cnn():
    return _pair(jc.BasicCnnSegmSigmoid, BasicCnnSegmSigmoid, CNN, 0)


@pytest.fixture(scope="module")
def hcqt():
    """A raw (uncompressed) 'HCQT' of 50 frames."""
    return np.random.RandomState(7).rand(6, 50, 216).astype(np.float32)


def test_predict_dense_matches_jax(cnn, hcqt):
    jm, v, tm = cnn
    want = np.asarray(jinf.predict_dense(jm.apply, v, hcqt))
    got = predict_dense(tm, torch.from_numpy(hcqt))
    assert got.shape == want.shape == (50, 72)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    with pytest.raises(ValueError, match="eval mode"):
        predict_dense(tm.train(), torch.from_numpy(hcqt))
    tm.eval()


@pytest.mark.parametrize("chunk", [16, 50, 64])
def test_predict_dense_chunked_matches_jax(cnn, hcqt, chunk):
    """Chunks of 16 leave a ragged last chunk (padded), 50 fit exactly,
    64 is one chunk longer than the recording."""
    jm, v, tm = cnn
    want = np.asarray(jinf.predict_dense_chunked(jm.apply, v, hcqt,
                                                 chunk=chunk))
    got = predict_dense_chunked(tm, torch.from_numpy(hcqt), chunk=chunk)
    assert got.shape == want.shape == (50, 72)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_dense_modes_see_real_context_where_windows_see_zeros(cnn, hcqt):
    """The dense pass is not the windowed protocol: each window's convs
    zero-pad its time edges, where the dense pass sees the neighbouring
    frames. The chunked pass equals the dense one on frames whose
    receptive field (75 frames and a halo of 15 on each side) lies inside
    their chunk's span."""
    _, _, tm = cnn
    x = torch.from_numpy(hcqt)
    dense = predict_dense(tm, x)
    windowed = predict_framewise(tm, x, batch_size=16)
    assert float((dense - windowed).abs().max()) > ATOL
    chunked = predict_dense_chunked(tm, x, chunk=25)
    # frame j of chunk 0 reads padded frames up to j + 89 of its 100
    torch.testing.assert_close(chunked[:10], dense[:10], rtol=0, atol=1e-6)


def test_predict_framewise_return_aux_matches_jax(hcqt):
    """The PUnet's (salience, polyphony logits) through the windowed
    protocol: batches of 16 and the natural-size tail of 2."""
    jm, v, tm = _pair(ju.SimpleUNetPolyphonyClassifSoftmax,
                      SimpleUNetPolyphonyClassifSoftmax, PUNET, 1)
    x = hcqt[:, :34]
    want, want_aux = jinf.predict_framewise(jm.apply, v, x, batch_size=16,
                                            return_aux=True)
    got, got_aux = predict_framewise(tm, torch.from_numpy(x), batch_size=16,
                                     return_aux=True)
    assert got.shape == (34, 72) and got_aux.shape == (34, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux),
                               atol=ATOL, rtol=1e-4)
    plain = predict_framewise(tm, torch.from_numpy(x), batch_size=16)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_return_aux_of_a_single_output_model_is_empty(cnn, hcqt):
    _, _, tm = cnn
    pred, aux = predict_framewise(tm, torch.from_numpy(hcqt[:, :20]),
                                  batch_size=8, return_aux=True)
    assert pred.shape == (20, 72) and aux.shape == (20, 0)


@pytest.mark.parametrize("name,loss", [
    ("exp195f_musicnet_unet_extremelylarge_polyphony_softmax", "multitask"),
    ("exp126c_musicnet_cnn_verywide", "bce"),
])
def test_run_experiment_serves_the_zoo(tmp_path, name, loss):
    """``run_experiment`` end to end on the CPU: the smoke geometry, one
    epoch of one batch, one test file; the PUnet trains on the multitask
    loss and its test phase serves its salience output."""
    cfg = shrink_for_smoke(load_experiment(name))
    assert cfg.train_config.loss == loss
    cfg = dataclasses.replace(
        cfg, test_versions=cfg.test_versions[:1], test_versions_small=[],
        train_config=dataclasses.replace(cfg.train_config, batch_size=4,
                                         max_train_batches=1))
    corpus = SyntheticCorpus(cfg, frames=200)
    out = str(tmp_path / "run")
    res = run_experiment(cfg, corpus, out, max_epochs_override=1,
                         logger=logging.getLogger("test.zoo"), device="cpu")
    assert np.isfinite(res["history"]["train_loss"][0])
    agg = res["subsets"][0]
    assert agg["n_files"] == 1
    assert all(math.isfinite(v) for v in agg["framewise_mean"].values())
    fn = os.listdir(os.path.join(out, "predictions", cfg.name))[0]
    pred = np.load(os.path.join(out, "predictions", cfg.name, fn))
    assert pred.shape == (200, 72) and 0 <= pred.min() <= pred.max() <= 1
