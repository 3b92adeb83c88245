"""The port's augmentation chain and training pipeline against the JAX
package, on the CPU.

The two frameworks draw different random numbers, so each test
recomputes the JAX package's draws from its keys, exactly as the JAX
function makes them, and feeds them to the port's ``apply_*``: the
outputs must then agree to 1e-6 (float32 elementwise work in the same
order; only ``log1p`` is each library's own). The transposition's
rolled-in bins take the JAX noise at the same bins, so they agree too.
The port's own draws are held to their ranges and distributions, and
the pipeline to JAX's centers and batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.data import augment as ja
from multipitch_architectures_tpu.data import pipeline as jp
from multipitch_architectures_tpu.data import windows as jw
from multipitch_architectures_tpu_torch.data import (
    AugmentConfig, FileSpec, TrainPipeline, apply_augment, apply_eq,
    apply_noise, apply_time_scale, apply_transposition, apply_tuning,
    augment_batch, draw_augment, draw_eq, draw_transposition, draw_tuning,
    fold_in, gather_targets, log_compress, num_segments, num_windows,
    window_centers)

TOL = 1e-6
B, C, T, F = 6, 6, 75, 216
# the exp180d training recipe (registry.json)
RECIPE = dict(transposition=5, randomeq=20, noisestd=1e-4, tuning=True,
              compression=10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed=0, b=B, t=T):
    return np.random.RandomState(seed).rand(b, C, t, F).astype(np.float32)


def _y(seed=0, b=B, n=72):
    rng = np.random.RandomState(seed + 100)
    return (rng.rand(b, 1, 1, n) > 0.8).astype(np.float32)


def _keys(seed, b=B):
    return jax.random.split(jax.random.PRNGKey(seed), b)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the JAX package's draws, recomputed from its keys ----------------------

def _jax_eq_draws(keys, max_alpha):
    def one(k):
        ka, kb = jax.random.split(k)
        return (jax.random.randint(ka, (16,), 1, max_alpha + 1),
                jax.random.randint(kb, (16,), 0, F))
    a, b = jax.vmap(one)(keys)
    return _t(a).long(), _t(b).long()


def _jax_noise_draws(keys, shape, std):
    return _t(jax.vmap(lambda k: std * jax.random.normal(k, shape))(keys))


def _jax_tuning_draws(keys, shape):
    def one(k):
        kshift, knoise = jax.random.split(k)
        return (jax.random.randint(kshift, (), -2, 3),
                jax.numpy.abs(1e-4 * jax.random.normal(
                    knoise, shape[:-1] + (1,))))
    s, e = jax.vmap(one)(keys)
    return _t(s).long(), _t(e)


def _jax_transposition_draws(keys, shape, k_max):
    """(semitones, the port's compact edge noise): bin j of a sample's
    rolled-in run takes JAX's full-size noise at that bin."""
    def one(k):
        ktr, knoise = jax.random.split(k)
        return (jax.random.randint(ktr, (), -k_max, k_max + 1),
                jax.numpy.abs(1e-4 * jax.random.normal(knoise, shape)))
    tr, full = (np.asarray(a) for a in jax.vmap(one)(keys))
    edge = np.zeros(full.shape[:-1] + (3 * k_max,), np.float32)
    f = shape[-1]
    for i, t in enumerate(tr):
        n = 3 * abs(int(t))
        first = 0 if t >= 0 else f - n
        edge[i, ..., :n] = full[i, ..., first:first + n]
    return _t(tr).long(), _t(edge)


def _jax_scale_draws(keys):
    return _t(jax.vmap(jax.random.uniform)(keys))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


# -- each augmentation against its JAX function -----------------------------

@pytest.mark.parametrize("max_alpha", [20, 400])
def test_eq_matches_jax(max_alpha):
    """max_alpha 20 (the recipe) accepts most candidates; 400 rejects
    some samples' all 16, which take the all-pass filter."""
    x, keys = _x(1), _keys(1)
    want = jax.vmap(lambda k, xi: ja.random_eq(k, xi, max_alpha))(
        keys, jnp.asarray(x))
    _close(apply_eq(_t(x), *_jax_eq_draws(keys, max_alpha)), want)


def test_noise_and_compression_match_jax():
    x, keys = _x(2), _keys(2)
    want = jax.vmap(lambda k, xi: ja.random_noise(k, xi, 1e-4))(
        keys, jnp.asarray(x))
    got = apply_noise(_t(x), _jax_noise_draws(keys, x.shape[1:], 1e-4))
    _close(got, want)
    _close(log_compress(got, 10.0), ja.log_compress(want, 10.0))
    assert log_compress(got, None) is got


def _keys_covering(values, draw, seed=3):
    """One JAX key for each of ``values`` of the scalar ``draw(key)``."""
    found = {}
    base = jax.random.PRNGKey(seed)
    for i in range(400):
        k = jax.random.fold_in(base, i)
        found.setdefault(int(draw(k)), k)
        if set(values) <= set(found):
            return jnp.stack([found[v] for v in values])
    raise AssertionError(f"no key for {set(values) - set(found)}")


def test_tuning_shift_matches_jax_for_every_shift():
    keys = _keys_covering(range(-2, 3), lambda k: jax.random.randint(
        jax.random.split(k)[0], (), -2, 3))
    x = _x(4, b=5)
    want = jax.vmap(ja.random_tuning_shift)(keys, jnp.asarray(x))
    shift2, edge = _jax_tuning_draws(keys, x.shape[1:])
    assert shift2.tolist() == [-2, -1, 0, 1, 2]
    _close(apply_tuning(_t(x), shift2, edge), want)


@pytest.mark.parametrize("n_bins", [72, 12])
def test_transposition_matches_jax(n_bins):
    """Up, down and zero shifts; 12-bin chroma targets roll circularly."""
    k_max = 5
    keys = _keys_covering((-5, -2, 0, 3, 5), lambda k: jax.random.randint(
        jax.random.split(k)[0], (), -k_max, k_max + 1))
    x, y = _x(5, b=5), _y(5, b=5, n=n_bins)
    wx, wy = jax.vmap(lambda k, xi, yi: ja.random_transposition(
        k, xi, yi, k_max))(keys, jnp.asarray(x), jnp.asarray(y))
    transp, edge = _jax_transposition_draws(keys, x.shape[1:], k_max)
    gx, gy = apply_transposition(_t(x), _t(y), transp, edge)
    _close(gx, wx)
    _close(gy, wy)


def test_time_scale_matches_jax():
    x, keys = _x(6, t=140), _keys(6)
    want = jax.vmap(lambda k, xi: ja.time_scale(k, xi, 1.3, 75))(
        keys, jnp.asarray(x))
    _close(apply_time_scale(_t(x), _jax_scale_draws(keys), 1.3, 75), want)


@pytest.mark.parametrize("scaling", [None, 1.25])
def test_augment_chain_matches_jax(scaling):
    """The whole chain, in the reference's order, with the recipe's
    settings (and time scaling first for the segment datasets)."""
    cfg = AugmentConfig(scalingfactor=scaling, **RECIPE)
    jcfg = ja.AugmentConfig(scalingfactor=scaling, **RECIPE)
    t = 140 if scaling else T
    x, y = _x(7, t=t), _y(7)
    key = jax.random.PRNGKey(7)
    wx, wy = ja.augment_batch(key, jnp.asarray(x), jnp.asarray(y), jcfg, 75)
    per = jax.vmap(lambda k: jax.random.split(k, 5))(
        jax.random.split(key, B))                      # (B, 5, 2)
    k_scale, k_eq, k_noise, k_tune, k_tr = (per[:, i] for i in range(5))
    draws = {"eq": _jax_eq_draws(k_eq, 20),
             "noise": _jax_noise_draws(k_noise, x.shape[1:], 1e-4),
             "tuning": _jax_tuning_draws(k_tune, x.shape[1:]),
             "transposition": _jax_transposition_draws(k_tr, x.shape[1:], 5)}
    if scaling:
        draws["scale"] = _jax_scale_draws(k_scale)
    gx, gy = apply_augment(_t(x), _t(y), draws, cfg, 75)
    _close(gx, wx)
    _close(gy, wy)


# -- the port's own draws ---------------------------------------------------

def test_draws_are_in_range_and_seeded():
    gen = torch.Generator().manual_seed(0)
    alphas, betas = draw_eq(gen, 500, 20, F)
    assert alphas.min() == 1 and alphas.max() == 20
    assert betas.min() == 0 and betas.max() == F - 1
    shift2, edge = draw_tuning(gen, (500, C, 4, F))
    assert sorted(shift2.unique().tolist()) == [-2, -1, 0, 1, 2]
    assert edge.shape == (500, C, 4, 1) and edge.min() >= 0
    transp, tedge = draw_transposition(gen, (2000, 1, 2, F), 5)
    assert sorted(transp.unique().tolist()) == list(range(-5, 6))
    assert tedge.shape == (2000, 1, 2, 15)
    # |N(0, 1e-4)|: mean 1e-4·sqrt(2/pi)
    assert abs(float(tedge.mean()) / (1e-4 * np.sqrt(2 / np.pi)) - 1) < 0.02
    cfg = AugmentConfig(scalingfactor=1.25, **RECIPE)

    def draws(seed):
        return draw_augment(torch.Generator().manual_seed(seed),
                            (B, C, 140, F), cfg)

    a, b, c = draws(1), draws(1), draws(2)
    assert sorted(a) == ["eq", "noise", "scale", "transposition", "tuning"]
    flat = [torch.cat([t.flatten().double() for t in
                       (v if isinstance(v, tuple) else (v,))])
            for d in (a, b, c) for v in d.values()]
    n = len(a)
    assert all(torch.equal(p, q) for p, q in zip(flat[:n], flat[n:2 * n]))
    assert not torch.equal(flat[1], flat[2 * n + 1])      # eq differs


def test_augmented_batch_invariants():
    """The recipe's chain on a batch: finite, non-negative features within
    log1p(10·(max + noise)); EQ filters in [0, 1]; targets stay binary
    with at most the input's active bins."""
    x, y = _t(_x(8)), _t(_y(8))
    gen = torch.Generator().manual_seed(8)
    gx, gy = augment_batch(gen, x, y, AugmentConfig(**RECIPE))
    assert gx.shape == x.shape and gy.shape == y.shape
    assert torch.isfinite(gx).all() and gx.min() >= 0
    assert gx.max() <= np.log1p(10 * (float(x.max()) + 1e-2))
    assert set(gy.unique().tolist()) <= {0.0, 1.0}
    assert (gy.sum(dim=-1) <= y.sum(dim=-1)).all()
    alphas, betas = draw_eq(torch.Generator().manual_seed(9), B, 20, F)
    ones = torch.ones(B, C, 1, F)
    filt = apply_eq(ones, alphas, betas)
    assert filt.min() >= 0 and filt.max() <= 1


# -- the pipeline -----------------------------------------------------------

def _files():
    rng = np.random.RandomState(10)
    return [(rng.rand(C, t, F).astype(np.float32),
             (rng.rand(t, 128) > 0.9).astype(np.float32), s)
            for t, s in ((400, None), (333, 7), (260, None))]


def test_pipeline_centers_targets_and_plain_batches_match_jax():
    files = _files()
    ours = TrainPipeline([FileSpec(*f) for f in files], stride=50,
                         device="cpu")
    theirs = jp.TrainPipeline([jp.FileSpec(*f) for f in files], stride=50)
    np.testing.assert_array_equal(ours.centers.numpy(), theirs.centers)
    np.testing.assert_array_equal(
        window_centers(400, 75, 50, offset=9), jw.window_centers(
            400, 75, 50, offset=9))
    for t in (74, 75, 124, 125, 400):
        assert num_windows(t, 75, 50) == jw.num_windows(t, 75, 50)
        assert num_segments(t, 75, 10, 5) == jw.num_segments(t, 75, 10, 5)
    np.testing.assert_array_equal(ours.inputs.numpy(),
                                  np.asarray(theirs.inputs))
    idx = theirs.centers[::3]
    np.testing.assert_array_equal(
        gather_targets(ours.targets, idx).numpy(),
        np.asarray(jw.gather_targets(theirs.targets, idx)))
    got = list(ours.batches(0, 8, shuffle=False, drop_remainder=False))
    want = list(theirs.batches(jax.random.PRNGKey(0), 8, shuffle=False,
                               drop_remainder=False))
    assert [len(g[0]) for g in got] == [len(w[0]) for w in want]
    assert len(got[-1][0]) < 8                            # the ragged tail
    for (gx, gy), (wx, wy) in zip(got, want):
        _close(gx, wx)
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    for (gx, _), (wx, _) in zip(ours.all_windows(16), theirs.all_windows(16)):
        _close(gx, wx)


def test_shuffled_epoch_is_a_pure_permutation_of_seed_and_epoch():
    """Inputs hold each frame's index, so a window names its center.
    Integer seeds: the same seed gives the same batches, another seed
    another order, and each epoch covers every window once."""
    t = 600
    frame = np.broadcast_to(np.arange(t, dtype=np.float32)[None, :, None],
                            (1, t, 4)).copy()
    p = TrainPipeline([FileSpec(frame, np.zeros((t, 8), np.float32))],
                      stride=5, augment=AugmentConfig(compression=None),
                      target_slice=None, device="cpu")

    def order(seed):
        return torch.cat([x[:, 0, 37, 0] for x, _ in
                          p.batches(seed, 16, drop_remainder=False)]).long()

    a, b, c = order(fold_in(1, 0)), order(fold_in(1, 0)), order(fold_in(1, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert sorted(a.tolist()) == p.centers.tolist()
    assert sorted(c.tolist()) == p.centers.tolist()
    # drop_remainder drops only the short last batch
    kept = list(p.batches(3, 16))
    assert len(kept) == len(p) // 16 and all(len(x) == 16 for x, _ in kept)


def test_fold_in_is_pure_and_spreads():
    assert fold_in(0, 1, 2) == fold_in(0, 1, 2)
    seeds = {fold_in(0, e, s, i) for e in range(4) for s in range(4)
             for i in range(8)}
    assert len(seeds) == 128 and all(0 <= s < 2 ** 63 for s in seeds)
