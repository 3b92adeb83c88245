"""The port's reference-compatible Dataset classes (``data/datasets.py``)
against the JAX package's, on the CPU: for each of the five classes, on
the same numpy inputs and seed, the same ``len``; the same items bit for
bit, every augmentation on where the class has them (20 indices, drawn
in the same order on both sides, so the generators' draws line up); and
a ``DataLoader`` collates the items into float32 CPU batches.
"""

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

from multipitch_architectures_tpu.data import datasets as jds
from multipitch_architectures_tpu_torch.data import datasets as tds

T = 900
AUG = {"compression": 10.0, "aug:transpsemitones": 5, "aug:randomeq": 20,
       "aug:noisestd": 1e-4, "aug:tuning": True, "aug:smooth_len": 4,
       "aug:smooth_win": "hann", "seed": 7}
MEASURES = np.arange(40, T - 60, 25)

# name -> (params, targets' bins, the first valid index)
CASES = {
    "dataset_context": (dict(AUG, context=75, stride=3), 72, 0),
    "dataset_context_segm": (dict(AUG, context=75, seglength=30, stride=11,
                                  **{"aug:scalingfactor": 1.25}), 72, 0),
    "dataset_context_segm_pitch": (dict(context=75, seglength=30, stride=9,
                                        compression=10.0), 128, 0),
    # its 500-frame HCQT patch needs index·stride + 52 >= 250 + 37
    "dataset_context_segm_widetarget": (dict(context=75, seglength=30,
                                             stride=9, compression=10.0),
                                        72, 27),
    "dataset_context_measuresegm": (dict(context=75, seglength=4, stride=1,
                                         compression=10.0), 72, 0),
}


def _data(bins):
    rng = np.random.RandomState(2)
    inputs = rng.rand(6, T, 216).astype(np.float32)
    targets = (rng.rand(T, bins) > 0.85).astype(np.float32)
    return inputs, targets


def _build(module, name, **drop):
    params, bins, _ = CASES[name]
    params = {k: v for k, v in params.items() if k not in drop}
    inputs, targets = _data(bins)
    extra = (MEASURES,) if name == "dataset_context_measuresegm" else ()
    return getattr(module, name)(inputs, targets, *extra, params)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dataset_items_equal_jax(name):
    ours, theirs = _build(tds, name), _build(jds, name)
    assert isinstance(ours, torch.utils.data.Dataset)
    assert len(ours) == len(theirs) > 20
    first = CASES[name][2]
    for i in np.random.RandomState(0).randint(first, len(ours), 20):
        x, y = ours[int(i)]
        jx, jy = theirs[int(i)]
        assert x.dtype == y.dtype == torch.float32
        assert x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), jx, err_msg=f"x {i}")
        np.testing.assert_array_equal(y.numpy(), jy, err_msg=f"y {i}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_dataloader_collates(name):
    """A DataLoader stacks the items; time scaling, which gives each item
    a length of its own (as in the reference), is left out."""
    ds = _build(tds, name, **{"aug:scalingfactor": None})
    first = CASES[name][2]
    loader = DataLoader(torch.utils.data.Subset(ds, range(first, first + 8)),
                        batch_size=4)
    x, y = next(iter(loader))
    want_x, want_y = ds[first]
    assert x.shape == (4, *want_x.shape) and y.shape == (4, *want_y.shape)
    assert x.dtype == torch.float32


def test_scaling_raises_for_dataset_context():
    inputs, targets = _data(72)
    ds = tds.dataset_context(inputs, targets, dict(
        context=75, stride=3, **{"aug:scalingfactor": 1.25}))
    with pytest.raises(AssertionError, match="Scaling"):
        ds[0]
