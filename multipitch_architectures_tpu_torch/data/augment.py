"""Data augmentation on whole batches, on the tensors' device.

Counterpart of ``multipitch_architectures_tpu/data/augment.py``: the
reference's per-item augmentations (libdl/data_loaders/hcqt_datasets.py:
77-139), applied in the SAME order: random EQ -> additive noise -> log
compression -> tuning shift -> transposition (time scaling first for the
segment datasets). Shapes: X (B, C, T, F) (C = 6 harmonics, F = 216
bins, 3 bins per semitone), y (B, 1, 1, n_bins) center-frame targets.

Each augmentation is split into a ``draw_*`` that takes every random
value of the batch from an explicit ``torch.Generator`` on the data's
device, and an ``apply_*`` that takes those values. Per-sample shifts
and rolls are index gathers over the batch, never a loop over samples.
The random values are not the JAX package's (another generator); given
the same values, each ``apply_*`` computes what its JAX function does.

The JAX package's two documented deviations from the reference are kept:

- the EQ's rejection loop ("resample (alpha, beta) until the parabola
  stays >= 0", hcqt_datasets.py:80-95) draws 16 candidates and takes the
  first accepted one (all-pass when none is);
- ``time_scale`` keeps the output length fixed and resamples the
  interior at a random rate.
"""

from dataclasses import dataclass
from typing import Optional

import torch

# per-harmonic-channel EQ center offsets in bins: channel 0 is the
# subharmonic (offset -36), channels h>=1 sit at 36*log2(h) bins
# (hcqt_datasets.py:87-92)
_EQ_OFFSETS = (-36, 0, 36, 57, 72, 83)
EQ_CANDIDATES = 16
EDGE_NOISE_STD = 1e-4    # |N(0, 1e-4)| fills rolled-in bins (:121)


@dataclass(frozen=True)
class AugmentConfig:
    """Mirrors the reference's ``aug:*`` params (hcqt_datasets.py:46-55)."""

    transposition: Optional[int] = None      # aug:transpsemitones
    scalingfactor: Optional[float] = None    # aug:scalingfactor (segm only)
    randomeq: Optional[int] = None           # aug:randomeq (max alpha)
    noisestd: Optional[float] = None         # aug:noisestd
    tuning: bool = False                     # aug:tuning
    compression: Optional[float] = 10.0      # log(1 + gamma X)


def _edge_noise(gen, shape, device):
    return (EDGE_NOISE_STD * torch.randn(shape, generator=gen,
                                         device=device)).abs()


def _take_bins(x, idx):
    """x[b, ..., idx[b, f]]: a per-sample gather along the last axis;
    idx (B, F')."""
    view = (idx.shape[0],) + (1,) * (x.dim() - 2) + (idx.shape[1],)
    return torch.gather(x, -1, idx.view(view).expand(
        *x.shape[:-1], idx.shape[1]))


# -- random EQ --------------------------------------------------------------

def draw_eq(gen, batch: int, max_alpha: int, n_bins: int, device=None,
            n_candidates: int = EQ_CANDIDATES):
    """(alphas, betas), each (B, n_candidates): alpha in [1, max_alpha],
    beta in [0, n_bins)."""
    alphas = torch.randint(1, max_alpha + 1, (batch, n_candidates),
                           generator=gen, device=device)
    betas = torch.randint(0, n_bins, (batch, n_candidates), generator=gen,
                          device=device)
    return alphas, betas


def apply_eq(x, alphas, betas):
    """Parabolic EQ over frequency with a per-harmonic center offset:
    filt[c, f] = 1 - 2e-6·alpha·(f - (beta - offset_c))², for each
    sample the first candidate whose filter stays >= 0 (all-pass when
    none does)."""
    b, c, _, f = x.shape
    bins = torch.arange(f, device=x.device)
    offs = torch.tensor(_EQ_OFFSETS[:c], device=x.device)
    centers = betas[:, :, None, None] - offs[:, None]           # (B, N, C, 1)
    filt = 1.0 - 2e-6 * alphas[:, :, None, None] * (bins - centers) ** 2
    ok = filt.amin(dim=(2, 3)) >= 0                             # (B, N)
    pick = ok.int().argmax(dim=1)                               # first max
    chosen = filt[torch.arange(b, device=x.device), pick]       # (B, C, F)
    chosen = torch.where(ok.any(dim=1)[:, None, None], chosen,
                         torch.ones_like(chosen))
    return x * chosen[:, :, None, :].to(x.dtype)


# -- additive noise, compression --------------------------------------------

def draw_noise(gen, shape, std: float, device=None):
    """std·N(0, 1) of ``shape``."""
    return std * torch.randn(shape, generator=gen, device=device)


def apply_noise(x, noise):
    """X <- |X + noise| (hcqt_datasets.py:99-102)."""
    return (x + noise).abs()


def log_compress(x, gamma: Optional[float]):
    """X <- log(1 + gamma·X) (hcqt_datasets.py:105-106)."""
    if gamma is None:
        return x
    return torch.log1p(gamma * x)


# -- tuning shift -----------------------------------------------------------

def draw_tuning(gen, shape, device=None):
    """(shift in half bins (B,) in {-2, ..., 2}, edge noise (B, C, T, 1))."""
    b, c, t, _ = shape
    shift2 = torch.randint(-2, 3, (b,), generator=gen, device=device)
    return shift2, _edge_noise(gen, (b, c, t, 1), device)


def apply_tuning(x, shift2, edge):
    """Shift each sample by ``shift2`` half bins over frequency: whole
    bins roll, half bins average two neighbours; the one rolled-in edge
    bin takes ``edge`` (hcqt_datasets.py:108-124)."""
    f = x.shape[-1]
    bins = torch.arange(f, device=x.device)
    s = shift2[:, None]
    # out[f] = x at f - s/2: the mean of its floor and ceil neighbours
    lo = (bins - torch.div(s + 1, 2, rounding_mode="floor")) % f
    hi = (bins - torch.div(s, 2, rounding_mode="floor")) % f
    shifted = (_take_bins(x, lo) + _take_bins(x, hi)) / 2
    rolled_in = ((bins == 0) & (s > 0)) | ((bins == f - 1) & (s < 0))
    return torch.where(rolled_in[:, None, None, :], edge, shifted)


# -- transposition ----------------------------------------------------------

def draw_transposition(gen, shape, max_semitones: int, device=None):
    """(semitones (B,) in [-k, k], edge noise (B, C, T, 3k) for the up to
    3k rolled-in bins)."""
    b, c, t, _ = shape
    transp = torch.randint(-max_semitones, max_semitones + 1, (b,),
                           generator=gen, device=device)
    return transp, _edge_noise(gen, (b, c, t, 3 * max_semitones), device)


def _roll_mask(n, shift, device):
    """(source index (B, n) of a roll by ``shift`` (B, 1), rolled-in
    mask (B, n))."""
    bins = torch.arange(n, device=device)
    src = (bins - shift) % n
    wrap = torch.where(shift >= 0, bins < shift, bins >= n + shift)
    return src, wrap


def apply_transposition(x, y, transp, edge):
    """Transpose each sample by ``transp`` semitones: X rolls by 3k bins,
    y by k bins; rolled-in X bins take ``edge`` (bin j of the rolled-in
    run takes ``edge[..., j]``), rolled-in y bins are zeroed, except for
    12-bin chroma targets, which keep the circular roll
    (hcqt_datasets.py:126-139)."""
    f, n_bins = x.shape[-1], y.shape[-1]
    shift = 3 * transp[:, None]
    src, wrap = _roll_mask(f, shift, x.device)
    bins = torch.arange(f, device=x.device)
    j = torch.where(shift >= 0, bins, bins - f - shift)
    noise = _take_bins(edge, j.clamp(0, edge.shape[-1] - 1))
    x_out = torch.where(wrap[:, None, None, :], noise, _take_bins(x, src))
    ysrc, ywrap = _roll_mask(n_bins, transp[:, None], y.device)
    y_out = _take_bins(y, ysrc)
    if n_bins != 12:
        y_out = y_out.masked_fill(ywrap[:, None, None, :], 0.0)
    return x_out, y_out


# -- time scaling -----------------------------------------------------------

def draw_time_scale(gen, batch: int, device=None):
    """U[0, 1) per sample."""
    return torch.rand((batch,), generator=gen, device=device)


def apply_time_scale(x, u, max_factor: float, context: int):
    """Resample each sample's interior frames (all but ``context//2`` at
    each end) at rate scalefac = 1/a + 2u(1 - 1/a), linear interpolation,
    fixed length (hcqt_datasets.py:211-226)."""
    t = x.shape[2]
    half = context // 2
    interior = x[:, :, half:t - half]
    n = interior.shape[2]
    scalefac = 1.0 / max_factor + 2.0 * u * (1.0 - 1.0 / max_factor)
    pos = (torch.arange(n, device=x.device) / scalefac[:, None]).clamp(0, n - 1)
    i0 = pos.floor().long()
    i1 = (i0 + 1).clamp(max=n - 1)
    frac = (pos - i0)[:, None, :, None]

    def frames(i):  # (B, n) -> (B, C, n, F)
        return torch.gather(interior, 2, i[:, None, :, None].expand(
            -1, interior.shape[1], -1, interior.shape[3]))

    scaled = frames(i0) * (1 - frac) + frames(i1) * frac
    return torch.cat([x[:, :, :half], scaled, x[:, :, t - half:]], dim=2)


# -- the chain --------------------------------------------------------------

def draw_augment(gen, x_shape, cfg: AugmentConfig, device=None) -> dict:
    """Every random value of one batch's augmentation chain, drawn in the
    chain's order: {'scale', 'eq', 'noise', 'tuning', 'transposition'}
    for the steps ``cfg`` enables."""
    b, _, _, f = x_shape
    draws = {}
    if cfg.scalingfactor:
        draws["scale"] = draw_time_scale(gen, b, device)
    if cfg.randomeq:
        draws["eq"] = draw_eq(gen, b, cfg.randomeq, f, device)
    if cfg.noisestd:
        draws["noise"] = draw_noise(gen, x_shape, cfg.noisestd, device)
    if cfg.tuning:
        draws["tuning"] = draw_tuning(gen, x_shape, device)
    if cfg.transposition:
        draws["transposition"] = draw_transposition(gen, x_shape,
                                                    cfg.transposition, device)
    return draws


def apply_augment(x, y, draws: dict, cfg: AugmentConfig, context: int = 75):
    """The chain on drawn values, in the reference's order."""
    if "scale" in draws:
        x = apply_time_scale(x, draws["scale"], cfg.scalingfactor, context)
    if "eq" in draws:
        x = apply_eq(x, *draws["eq"])
    if "noise" in draws:
        x = apply_noise(x, draws["noise"])
    x = log_compress(x, cfg.compression)
    if "tuning" in draws:
        x = apply_tuning(x, *draws["tuning"])
    if "transposition" in draws:
        x, y = apply_transposition(x, y, *draws["transposition"])
    return x, y


def augment_batch(gen, x, y, cfg: AugmentConfig, context: int = 75):
    """Draw from ``gen`` and apply the chain to a batch (B, C, T, F)."""
    return apply_augment(x, y, draw_augment(gen, x.shape, cfg, x.device),
                         cfg, context)


def augment_one(gen, x, y, cfg: AugmentConfig, context: int = 75):
    """:func:`augment_batch` on one sample: X (C, T, F), y (1, 1, n_bins)."""
    xb, yb = augment_batch(gen, x[None], y[None], cfg, context)
    return xb[0], yb[0]


# the JAX package's one-call forms, on a batch
def random_eq(gen, x, max_alpha: int):
    return apply_eq(x, *draw_eq(gen, x.shape[0], max_alpha, x.shape[-1],
                                x.device))


def random_noise(gen, x, std: float):
    return apply_noise(x, draw_noise(gen, x.shape, std, x.device))


def random_tuning_shift(gen, x):
    return apply_tuning(x, *draw_tuning(gen, x.shape, x.device))


def random_transposition(gen, x, y, max_semitones: int):
    return apply_transposition(x, y, *draw_transposition(
        gen, x.shape, max_semitones, x.device))


def time_scale(gen, x, max_factor: float, context: int):
    return apply_time_scale(x, draw_time_scale(gen, x.shape[0], x.device),
                            max_factor, context)
