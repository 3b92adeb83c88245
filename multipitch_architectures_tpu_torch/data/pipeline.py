"""Device-resident training pipeline.

Counterpart of ``multipitch_architectures_tpu/data/pipeline.py``, which
replaces the reference's ``ConcatDataset(per-file dataset_context) +
DataLoader(num_workers=16)`` (exp180d…py:281-288):

1. all files' HCQTs and targets are concatenated into one tensor pair on
   the device, ``context`` zero frames apart, so no window straddles two
   files;
2. each file's window centers are computed as ``window_centers`` does
   (hcqt_datasets.py:63-75), with the file's own stride where it has one;
3. an epoch is a permutation of the centers, drawn on the device;
4. each batch is one gather and the augmentation chain on the whole
   batch, on the device: no host copies, no worker processes.

Randomness is deterministic: given an integer seed, the permutation and
each batch draw from generators seeded by :func:`fold_in` of (seed,
stream, batch index), so batch ``i`` of an epoch is the same whether or
not the epochs before it ran.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import span
from .augment import AugmentConfig, augment_batch
from .windows import _gather, gather_targets, window_centers


def fold_in(*values: int) -> int:
    """A 63-bit seed that is a pure function of ``values`` (non-negative
    integers), through numpy's ``SeedSequence`` hash: the counterpart of
    ``jax.random.fold_in`` chains."""
    state = np.random.SeedSequence([int(v) for v in values]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


@dataclass
class FileSpec:
    """One recording: HCQT (C, T, F) and frame targets (T, n_bins).

    ``stride`` optionally overrides the pipeline stride for this file:
    the Exp4 big-mix study uses per-corpus strides (35/6/1/2/4,
    exp210d_bigmix…py:310-438, SURVEY §2.8)."""

    inputs: np.ndarray
    targets: np.ndarray
    stride: Optional[int] = None

    def __post_init__(self):
        if self.inputs.ndim != 3 or self.targets.ndim != 2 \
                or self.inputs.shape[1] != self.targets.shape[0]:
            raise ValueError(f"FileSpec wants inputs (C, T, F) and targets "
                             f"(T, n_bins), got {self.inputs.shape} and "
                             f"{self.targets.shape}")


class TrainPipeline:
    """Concatenated window sampler with augmentation, on one device.

    Args:
        files: list of :class:`FileSpec`.
        context: window length in frames (75 in all experiments).
        stride: hop between window starts (50 train / 1 test, SURVEY §2.2).
        augment: :class:`AugmentConfig` (None -> compression only).
        target_slice: (lo, hi) slice of target bins (experiments use
            (24, 96) -> 72 MIDI pitches, exp180d…py:258-288).
        compression: log-compression gamma when ``augment`` is None.
        device: where the data lives and batches are made; the card by
            default (raises without one unless ``device="cpu"``).
    """

    def __init__(self, files: Sequence[FileSpec], context: int = 75,
                 stride: int = 50, augment: Optional[AugmentConfig] = None,
                 target_slice: Optional[Tuple[int, int]] = (24, 96),
                 compression: Optional[float] = 10.0, device=None):
        self.device = resolve_device(device)
        self.context = context
        self.augment = augment or AugmentConfig(compression=compression)
        pieces_x, pieces_y, centers = [], [], []
        offset = 0
        for f in files:
            x = np.asarray(f.inputs, np.float32)
            y = np.asarray(f.targets, np.float32)
            if target_slice is not None:
                y = y[:, target_slice[0]:target_slice[1]]
            centers.append(window_centers(x.shape[1], context,
                                          f.stride or stride, offset=offset))
            pieces_x += [x, np.zeros((x.shape[0], context, x.shape[2]),
                                     np.float32)]
            pieces_y += [y, np.zeros((context, y.shape[1]), np.float32)]
            offset += x.shape[1] + context
        self.inputs = torch.as_tensor(np.concatenate(pieces_x, axis=1),
                                      device=self.device)
        self.targets = torch.as_tensor(np.concatenate(pieces_y, axis=0),
                                       device=self.device)
        self.centers = torch.as_tensor(
            np.concatenate(centers) if centers else np.zeros(0, np.int64),
            device=self.device)

    def __len__(self):
        return len(self.centers)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _make_batch(self, gen, centers):
        with span("data.gather"):
            x = _gather(self.inputs, centers, self.context)
            y = gather_targets(self.targets, centers)
        with span("data.augment"):
            return augment_batch(gen, x, y, self.augment, self.context)

    def batches(self, generator_or_seed: Union[int, torch.Generator],
                batch_size: int, shuffle: bool = True,
                drop_remainder: bool = True):
        """Yield (X, y) batches for one epoch on the pipeline's device.

        X: (B, C, context, F) float32 (augmented and log-compressed),
        y: (B, 1, 1, n_bins). With an integer seed the permutation
        draws from ``fold_in(seed, 0)`` and batch ``i`` from
        ``fold_in(seed, 1, i)``; a ``torch.Generator`` on the device is
        drawn from in order instead.
        """
        n = len(self.centers)
        if isinstance(generator_or_seed, torch.Generator):
            def gen(*stream):
                return generator_or_seed
        else:
            def gen(*stream):
                return self._generator(fold_in(generator_or_seed, *stream))
        if shuffle:
            order = torch.randperm(n, generator=gen(0), device=self.device)
        else:
            order = torch.arange(n, device=self.device)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for i, start in enumerate(range(0, stop, batch_size)):
            with span("data.batch"):
                batch = self._make_batch(
                    gen(1, i), self.centers[order[start:start + batch_size]])
            yield batch

    def all_windows(self, batch_size: int = 256):
        """Every window once, in order (eval); the draws, where the
        augmentation makes any, come from a generator seeded 0 for each
        batch, as the JAX package's key 0."""
        for start in range(0, len(self.centers), batch_size):
            yield self._make_batch(self._generator(0),
                                   self.centers[start:start + batch_size])
