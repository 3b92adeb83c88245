"""Reference-compatible Dataset classes (host-side numpy).

Counterpart of ``multipitch_architectures_tpu/data/datasets.py``: the
five classes of the reference's libdl/data_loaders/hcqt_datasets.py as
``torch.utils.data.Dataset``s, with the same constructor arguments
(inputs, targets, a ``params`` dict with the ``aug:*`` keys), ``__len__``
and ``__getitem__``. An item is a pair of float32 CPU tensors: host data,
which a ``DataLoader(pin_memory=True)`` pins and the trainer moves to the
device. The augmentation draws its random values from a
``numpy.random.Generator`` seeded by ``params["seed"]``, in the JAX
package's order, so that a seeded item equals the JAX package's bit for
bit. The device-side fast path is :class:`data.TrainPipeline`; these
classes exist for the reference's API.
"""

import numpy as np
import torch
from torch.utils.data import Dataset

from .augment import _EQ_OFFSETS


def _to_np(a):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.asarray(a, np.float32)


def _item(x, y):
    """An item: float32 CPU tensors that own their memory."""
    return (torch.from_numpy(np.array(x, np.float32)),
            torch.from_numpy(np.array(y, np.float32)))


def _compressed(x, compression):
    if compression is None:
        return x
    return np.log1p(compression * x).astype(np.float32)


class _AugmentMixin:
    """The reference's augmentation chain on numpy arrays
    (hcqt_datasets.py:77-139), applied in the same order, each random
    value drawn from ``self.rng`` as the JAX package draws it."""

    def _init_aug(self, params):
        self.compression = params.get("compression", None)
        self.transposition = params.get("aug:transpsemitones", None)
        self.scalingfactor = params.get("aug:scalingfactor", None)
        self.randomeq = params.get("aug:randomeq", None)
        self.noisestd = params.get("aug:noisestd", None)
        self.tuning = params.get("aug:tuning", None)
        self.rng = np.random.default_rng(params.get("seed", None))
        if params.get("aug:smooth_len", 0) and params["aug:smooth_len"] > 1:
            from scipy import signal

            kernel = signal.get_window(params["aug:smooth_win"],
                                       params["aug:smooth_len"] + 1)[1:, None]
            t = signal.convolve(self.targets, kernel, mode="same")
            self.targets = (t / t.max()).astype(np.float32)

    def _edge_noise(self, shape):
        return np.abs(self.rng.normal(0.0, 1e-4, shape)).astype(np.float32)

    def _apply_randomeq(self, x):
        c, t, f = x.shape
        bins = np.arange(f)
        while True:
            alpha = self.rng.integers(1, self.randomeq + 1)
            beta = self.rng.integers(0, f)
            filt = np.stack([
                1.0 - 2e-6 * alpha * (bins - (beta - off)) ** 2
                for off in _EQ_OFFSETS[:c]
            ])                                              # (C, F)
            if filt.min() >= 0:
                break
        return x * filt[:, None, :].astype(np.float32)

    def _apply_noise(self, x):
        return np.abs(x + self.rng.normal(0.0, self.noisestd,
                                          x.shape)).astype(np.float32)

    def _apply_tuning(self, x):
        shift2 = int(self.rng.integers(-2, 3))
        out = x.copy()
        if shift2 == 1:                                     # +0.5 bin
            out[..., 1:] = (x[..., :-1] + x[..., 1:]) / 2
        elif shift2 == -1:                                  # -0.5 bin
            out[..., :-1] = (x[..., :-1] + x[..., 1:]) / 2
        elif shift2 != 0:                                   # ±1 bin
            out = np.roll(x, shift2 // 2, axis=-1)
        if shift2 > 0:
            out[..., :1] = self._edge_noise(out[..., :1].shape)
        elif shift2 < 0:
            out[..., -1:] = self._edge_noise(out[..., -1:].shape)
        return out

    def _apply_transposition(self, x, y):
        k = int(self.rng.integers(-self.transposition,
                                  self.transposition + 1))
        xr = np.roll(x, 3 * k, axis=-1)
        yr = np.roll(y, k, axis=-1)
        if k > 0:
            xr[..., :3 * k] = self._edge_noise(xr[..., :3 * k].shape)
            if y.shape[-1] != 12:
                yr[..., :k] = 0.0
        elif k < 0:
            xr[..., 3 * k:] = self._edge_noise(xr[..., 3 * k:].shape)
            if y.shape[-1] != 12:
                yr[..., k:] = 0.0
        return xr, yr

    def _augment(self, x, y, allow_scaling=False):
        if self.scalingfactor and not allow_scaling:
            raise AssertionError("Scaling not implemented for dataset_context!")
        if self.randomeq:
            x = self._apply_randomeq(x)
        if self.noisestd:
            x = self._apply_noise(x)
        x = _compressed(x, self.compression)
        if self.tuning:
            x = self._apply_tuning(x)
        if self.transposition:
            x, y = self._apply_transposition(x, y)
        return _item(x, y)


class _Segments:
    """``__len__`` of the segment datasets (hcqt_datasets.py:194-196)."""

    def __len__(self):
        return ((self.inputs.shape[1] - self.context - self.seglength
                 + self.stride) // self.stride)


class dataset_context(_AugmentMixin, Dataset):
    """Single centre-frame windows (hcqt_datasets.py:10-141): X
    ``(C, context, F)``, y ``(1, 1, n_bins)``, the centre frame's target.
    ``aug:scalingfactor`` raises, as in the reference."""

    def __init__(self, inputs, targets, params):
        self.inputs = _to_np(inputs)
        self.targets = _to_np(targets)
        self.context = params["context"]
        self.stride = params["stride"]
        self.targettype = params.get("targettype", "pitch_class")
        self._init_aug(params)

    def __len__(self):
        return (self.inputs.shape[1] - self.context) // self.stride

    def __getitem__(self, index):
        index = index * self.stride + self.context // 2
        half = self.context // 2
        x = self.inputs[:, index - half:index + half + 1, :].copy()
        y = self.targets[index][None, None, :].copy()
        return self._augment(x, y)


class dataset_context_segm(_Segments, _AugmentMixin, Dataset):
    """Segment windows (hcqt_datasets.py:144-289): X covers
    ``seglength + context - 1`` frames, y the ``seglength`` centre frames,
    ``(1, 1, seglength, n_bins)``; ``aug:scalingfactor`` resamples the
    interior (time scaling) before the other augmentations."""

    def __init__(self, inputs, targets, params):
        self.inputs = _to_np(inputs)
        self.targets = _to_np(targets)
        self.context = params["context"]
        self.seglength = params["seglength"]
        self.stride = params["stride"]
        self._init_aug(params)

    def _scale(self, x):
        half = self.context // 2
        fac = self.scalingfactor
        scalefac = 1.0 / fac + 2.0 * self.rng.random() * (1.0 - 1.0 / fac)
        new_len = int(scalefac * self.seglength)
        interior = x[:, half:x.shape[1] - half, :]
        dst = np.linspace(0, interior.shape[1] - 1, new_len)
        i0 = np.floor(dst).astype(int)
        i1 = np.minimum(i0 + 1, interior.shape[1] - 1)
        frac = (dst - i0)[None, :, None]
        scaled = interior[:, i0, :] * (1 - frac) + interior[:, i1, :] * frac
        return np.concatenate(
            [x[:, :half, :], scaled.astype(np.float32),
             x[:, x.shape[1] - half:, :]], axis=1)

    def __getitem__(self, index):
        index = index * self.stride + self.context // 2
        half = self.context // 2
        x = self.inputs[:, index - half:index + self.seglength + half,
                        :].copy()
        y = (self.targets[index:index + self.seglength]
             .reshape(1, 1, self.seglength, -1).copy())
        if self.scalingfactor:
            x = self._scale(x)
        return self._augment(x, y, allow_scaling=True)


class dataset_context_segm_pitch(_Segments, Dataset):
    """Segment windows without augmentation, the targets sliced to MIDI
    24-96 (hcqt_datasets.py:292-335): y ``(1, 1, seglength, 72)``."""

    def __init__(self, inputs, targets, params):
        self.inputs = _to_np(inputs)
        self.targets = _to_np(targets)
        self.context = params["context"]
        self.seglength = params["seglength"]
        self.stride = params["stride"]
        self.compression = params.get("compression", None)

    def __getitem__(self, index):
        index = index * self.stride + self.context // 2
        half = self.context // 2
        x = self.inputs[:, index - half:index + self.seglength + half, :]
        y = self.targets[index:index + self.seglength, 24:96]
        return _item(_compressed(x, self.compression),
                     y.reshape(1, 1, self.seglength, 72))


class dataset_context_segm_widetarget(_Segments, Dataset):
    """A fixed 500-frame HCQT patch (plus the context) centred on a
    narrower target segment (hcqt_datasets.py:338-385)."""

    SEGL_HCQT = 500

    def __init__(self, inputs, targets, params):
        self.inputs = _to_np(inputs)
        self.targets = _to_np(targets)
        self.context = params["context"]
        self.seglength = params["seglength"]
        self.stride = params["stride"]
        self.compression = params.get("compression", None)

    def __getitem__(self, index):
        index = index * self.stride + self.context // 2
        half = self.context // 2
        idx_hcqt = index + self.seglength // 2 - self.SEGL_HCQT // 2
        x = self.inputs[:, idx_hcqt - half:idx_hcqt + self.SEGL_HCQT + half, :]
        y = self.targets[index:index + self.seglength]
        return _item(_compressed(x, self.compression),
                     y.reshape(1, 1, self.seglength, -1))


class dataset_context_measuresegm(Dataset):
    """Segments bounded by musical measure positions
    (hcqt_datasets.py:388-436): item ``i`` spans the frames from measure
    ``i·stride`` to measure ``i·stride + seglength``."""

    def __init__(self, inputs, targets, measures, params):
        self.inputs = _to_np(inputs)
        self.targets = _to_np(targets)
        self.measures = np.asarray(measures)
        self.context = params["context"]
        self.seglength = params["seglength"]
        self.stride = params["stride"]
        self.compression = params.get("compression", None)

    def __len__(self):
        return (self.measures.shape[0] - self.seglength - 1) // self.stride

    def __getitem__(self, index):
        index *= self.stride
        start = int(self.measures[index])
        end = int(self.measures[index + self.seglength])
        half = self.context // 2
        x = self.inputs[:, start - half:end + half, :]
        y = self.targets[start:end]
        return _item(_compressed(x, self.compression),
                     y.reshape(1, 1, end - start, -1))
