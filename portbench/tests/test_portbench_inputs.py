"""Traffic, audio, corpus and weights are pure functions of the seed."""

import numpy as np
import pytest
import torch

from portbench import inputs, traffic, weights
from portbench.common import load_json, ROOT
from portbench.reference.saunet import SAUnet

SEED = 2 ** 31 + 12345


def mix(name):
    return load_json(f"{ROOT}/portbench/traffic/{name}.json")


def test_requests_repeat_for_a_seed():
    for name in ("corpus", "clips"):
        a = traffic.requests(mix(name), SEED, 45)
        assert a == traffic.requests(mix(name), SEED, 45)
        b = traffic.requests(mix(name), SEED + 1, 45)
        # the same sizes (and gaps) for every seed, in another order, or
        # in the mix's own order where it names a schedule seed
        assert sorted(x for x, _ in a) == sorted(x for x, _ in b)
        assert (a == b) == ("schedule_seed" in mix(name))


def test_open_loop_fills_the_window():
    reqs = traffic.requests(mix("clips"), SEED, 45)
    due = [t for _, t in reqs]
    assert len(reqs) == round(mix("clips")["rate_per_s"] * 45)
    assert due[0] == 0 and max(due) < 45 and due == sorted(due)
    lengths = [x for x, _ in reqs]
    assert 1.0 < min(lengths) and max(lengths) < 4.0


def test_audio_and_corpus_repeat_for_a_seed():
    a = inputs.audio_pool([1.0, 2.0], SEED, 22050, "cpu")
    b = inputs.audio_pool([1.0, 2.0], SEED, 22050, "cpu")
    c = inputs.audio_pool([1.0, 2.0], SEED + 1, 22050, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[1].shape == (44100,) and a[1].dtype == np.float32
    f = inputs.training_corpus([200, 300], SEED, "cpu")
    g = inputs.training_corpus([200, 300], SEED, "cpu")
    for (x, y), (u, v) in zip(f, g):
        assert np.array_equal(x, u) and np.array_equal(y, v)
    assert f[1][0].shape == (6, 300, 216) and f[1][1].shape == (300, 72)


@pytest.mark.parametrize("law", weights.LAWS)
def test_weights_repeat_for_a_seed(law):
    with torch.device("meta"):
        m = SAUnet(n_chan_layers=(8, 6, 5, 4), scalefac=16, embed_dim=32,
                   mlp_dim=64, pos_encoding="sinusoidal")
    a = weights.draw(m, SEED, "cpu", law)
    b = weights.draw(m, SEED, "cpu", law)
    c = weights.draw(m, SEED + 1, "cpu", law)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["inc.double_conv.0.weight"],
                           c["inc.double_conv.0.weight"])
    assert torch.equal(a["down1.1.double_conv.1.running_var"],
                       torch.ones(8))
