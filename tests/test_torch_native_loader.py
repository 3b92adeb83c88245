"""The port's native window loader (``io/native_loader.py`` on its own
copy of the C++ source, ``csrc/npy_loader.cpp``) on the CPU: built with
g++ here, its ``fill`` equals the JAX package's ``NativeWindowLoader``
and the port's ``gather_windows`` bit for bit (into new arrays and into
caller tensors), ``trainer_batches(device="cpu")`` equals the JAX
package's ``trainer_batches`` (1e-6 after the ``log1p``), an abandoned
generator joins its thread, and a missing file raises ``IOError``.
"""

import os
import threading

import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.io import native_loader as jnative
from multipitch_architectures_tpu_torch.data import gather_windows
from multipitch_architectures_tpu_torch.io import (NativeWindowLoader,
                                                   build_native_library,
                                                   trainer_batches)

CONTEXT, STRIDE = 75, 7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two files in the precompute CLI's layout, HCQT (216, T, 6) and
    roll (128, T), one roll in float64; and their (6, T, 216) tensors."""
    tmp = tmp_path_factory.mktemp("npy")
    rng = np.random.RandomState(0)
    pairs, raws = [], []
    for i, (t, dtype) in enumerate([(300, np.float32), (251, np.float64)]):
        hcqt = rng.rand(216, t, 6).astype(np.float32)
        annot = (rng.rand(128, t) > 0.9).astype(dtype)
        pairs.append((str(tmp / f"h{i}.npy"), str(tmp / f"a{i}.npy")))
        np.save(pairs[-1][0], hcqt)
        np.save(pairs[-1][1], annot)
        raws.append((torch.from_numpy(hcqt.transpose(2, 1, 0).copy()),
                     torch.from_numpy(annot.astype(np.float32))))
    return pairs, raws


def test_build_is_the_ports_copy():
    lib = build_native_library()
    assert os.path.exists(lib)
    assert os.path.dirname(lib).endswith(os.path.join(
        "multipitch_architectures_tpu_torch", "csrc", "build"))


def test_fill_equals_jax_and_gather_windows(corpus):
    pairs, raws = corpus
    ours = NativeWindowLoader(pairs, CONTEXT, STRIDE, n_threads=3)
    theirs = jnative.NativeWindowLoader(pairs, CONTEXT, STRIDE, n_threads=3)
    n0 = (300 - CONTEXT) // STRIDE
    assert len(ours) == len(theirs) == n0 + (251 - CONTEXT) // STRIDE
    idx = np.random.RandomState(1).randint(0, len(ours), 200)
    x, y = ours.fill(idx)
    jx, jy = theirs.fill(idx)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    for k, i in enumerate(idx):
        f, local = (0, i) if i < n0 else (1, i - n0)
        inputs, roll = raws[f]
        center = local * STRIDE + CONTEXT // 2
        np.testing.assert_array_equal(
            x[k], gather_windows(inputs, [center], CONTEXT)[0].numpy())
        np.testing.assert_array_equal(y[k], roll[24:96, center].numpy())
    # into caller tensors (pinned ones on a machine with a card)
    bx = torch.empty((len(idx), 6, CONTEXT, 216))
    by = torch.empty((len(idx), 72))
    got_x, got_y = ours.fill(idx, bx, by)
    assert got_x is bx and got_y is by
    np.testing.assert_array_equal(bx.numpy(), x)
    np.testing.assert_array_equal(by.numpy(), y)
    with pytest.raises(ValueError, match="float32"):
        ours.fill(idx, bx.double(), by)


def test_trainer_batches_equal_jax(corpus):
    pairs, _ = corpus
    ours = NativeWindowLoader(pairs, CONTEXT, STRIDE, n_threads=2)
    theirs = jnative.NativeWindowLoader(pairs, CONTEXT, STRIDE, n_threads=2)
    got = list(trainer_batches(ours, 8, seed=3, device="cpu"))
    want = list(jnative.trainer_batches(theirs, 8, seed=3))
    assert len(got) == len(want) == len(ours) // 8
    for (x, y), (jx, jy) in zip(got, want):
        assert x.dtype == torch.float32 and y.shape == (8, 1, 1, 72)
        np.testing.assert_allclose(x.numpy(), jx, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(y.numpy(), jy)


def _threads_settle(before):
    for _ in range(50):
        if threading.active_count() <= before:
            return True
        threading.Event().wait(0.1)
    return False


def test_abandoned_generators_join_their_threads(corpus):
    pairs, _ = corpus
    loader = NativeWindowLoader(pairs, CONTEXT, STRIDE, n_threads=2)
    before = threading.active_count()
    for gen in (loader.batches(2, prefetch=1),
                trainer_batches(loader, 2, device="cpu", prefetch=1)):
        next(gen)
        assert threading.active_count() > before
        gen.close()
        assert _threads_settle(before)


def test_missing_file_raises_ioerror(corpus, tmp_path):
    pairs, _ = corpus
    with pytest.raises(IOError):
        NativeWindowLoader([(str(tmp_path / "none.npy"), pairs[0][1])])
