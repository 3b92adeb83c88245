"""The CQT octave kernel: framing, kernel-bank product and magnitude in one.

Counterpart of ``multipitch_architectures_tpu/ops/pallas_cqt.py``. For one
octave, ``mag[t, k] = sqrt(re² + im² + 1e-30)`` where
``[re | im] = y_padded[t·hop : t·hop + n_fft] @ kr`` and
``kr = [Re K | -Im K]`` has shape ``(n_fft, 2·bpo)``.

:func:`cqt_octaves` computes a work list of octaves (:class:`Octave`), each
scaled and written into its columns of a shared output, in one launch of
the CUDA kernel ``csrc/cqt_octave.cu`` for tensors on the card, and
through the plain version :func:`cqt_octaves_reference` for tensors on
the CPU. The kernel runs the product on tensor cores in split TF32 and
reads its banks in the layout :func:`bank_for_kernel` gives them.
:func:`cqt_octave` is one unscaled octave through the same kernel, for
the tests.
"""

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import counters
from . import _build

KC = 32              # the kernel's K chunk: n_fft must be a multiple of it
MAX_BPO = 64
MAX_N_FFT = 131072
MAX_ENTRIES = 32     # octaves per launch
WIDTHS = (24, 48, 72, 96, 120, 128)   # the kernel's wgmma widths N
TILE = 64            # the kernel's frames per block (cqt_octaves_tile)


def kernel_width(bpo: int) -> int:
    """The kernel's column count for ``bpo`` bins: ``2·bpo`` rounded up to
    a width it is compiled for (``width`` in the source)."""
    if not (1 <= bpo <= MAX_BPO and 2 * bpo % 8 == 0):
        raise ValueError(f"the kernel takes 1 <= bpo <= {MAX_BPO} with 2·bpo "
                         f"a multiple of 8, got bpo={bpo}")
    return next(n for n in WIDTHS if n >= 2 * bpo)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: the low 13 bits are 0."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def bank_for_kernel(kr: np.ndarray, kc: int = KC) -> np.ndarray:
    """The bank ``kr = [Re | -Im]`` (n_fft, 2·bpo) in the kernel's layout.

    Columns are interleaved (``2b`` the real part of bin b, ``2b + 1`` the
    imaginary one) and padded with zeros to :func:`kernel_width`; each
    value is split into ``hi = tf32(kr)`` and ``lo = tf32(kr - hi)``.
    Returns (n_fft / kc, 2, kc / 4, N, 4) float32: for each K chunk of
    ``kc`` rows (the kernel's KC), ``hi`` then ``lo``, each as planes of 4
    rows, column-major inside a plane (the 16-byte rows of the wgmma core
    matrices).
    """
    kr = np.asarray(kr, dtype=np.float32)
    n_fft, two_bpo = kr.shape
    bpo = two_bpo // 2
    if two_bpo % 2 or n_fft % kc:
        raise ValueError(f"want kr (n_fft, 2·bpo) with n_fft a multiple of "
                         f"{kc}, got {kr.shape}")
    cols = np.zeros((n_fft, kernel_width(bpo)), dtype=np.float32)
    cols[:, 0:two_bpo:2] = kr[:, :bpo]
    cols[:, 1:two_bpo:2] = kr[:, bpo:]
    hi = tf32_round(cols)
    lo = tf32_round(cols - hi)
    parts = np.stack([hi, lo])                       # (2, n_fft, N)
    n = cols.shape[1]
    # [part, chunk, plane, sample, column] -> [chunk, part, plane, column,
    # sample]
    return np.ascontiguousarray(
        parts.reshape(2, n_fft // kc, kc // 4, 4, n).transpose(1, 0, 2, 4, 3))


@dataclass(frozen=True, eq=False)
class Octave:
    """One entry of a work list: the magnitudes of ``n_frames`` frames of
    ``y``, times ``scale``, go to ``out[:n_frames, col:col + bpo]``.

    ``y`` is the octave's signal, already reflect-padded by ``n_fft // 2``;
    ``kr`` its (n_fft, 2·bpo) bank ``[Re | -Im]`` and ``bank`` the same in
    the kernel's layout (needed on the card only); ``scale`` (bpo,)
    float32; ``out`` a 2-D float32 tensor that other entries may share.
    """

    y: torch.Tensor
    kr: torch.Tensor
    bank: Optional[torch.Tensor]
    scale: torch.Tensor
    out: torch.Tensor
    hop: int
    n_fft: int
    n_frames: int
    col: int


class _Entry(ctypes.Structure):
    """``Entry`` of ``csrc/cqt_octave.cu``."""

    _fields_ = [("y", ctypes.c_void_p), ("len", ctypes.c_longlong),
                ("bank", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("hop", ctypes.c_int),
                ("n_fft", ctypes.c_int), ("n_frames", ctypes.c_int),
                ("col", ctypes.c_int), ("ld", ctypes.c_int)]


def cqt_octaves_reference(octaves: Sequence[Octave], *, bpo: int):
    """Plain PyTorch version of :func:`cqt_octaves`, on any device: each
    entry through :func:`cqt_octave_reference`, scaled, into its
    columns."""
    for o in octaves:
        mag = cqt_octave_reference(o.y, o.kr, hop=o.hop, n_fft=o.n_fft,
                                   bpo=bpo, n_frames=o.n_frames)
        o.out[:o.n_frames, o.col:o.col + bpo] = mag * o.scale


def launch_plan(octaves: Sequence[Octave], tile: int = TILE):
    """How the kernel walks a work list in blocks of ``tile`` frames:
    (order, starts). ``order`` lists the entries by n_fft, longest first,
    so that the blocks with the most work start first; ``starts[i]`` is
    the first block of ``octaves[order[i]]``, and ``starts[-1]`` the
    block count."""
    order = sorted(range(len(octaves)), key=lambda i: -octaves[i].n_fft)
    starts = [0]
    for i in order:
        starts.append(starts[-1] + -(-octaves[i].n_frames // tile))
    return order, starts


def _check(octaves, bpo):
    if not octaves:
        raise ValueError("empty work list")
    dev = octaves[0].y.device
    for o in octaves:
        need = (o.n_frames - 1) * o.hop + o.n_fft
        if o.y.dim() != 1 or o.kr.shape != (o.n_fft, 2 * bpo):
            raise ValueError(f"want y (L,) and kr ({o.n_fft}, {2 * bpo}), "
                             f"got {tuple(o.y.shape)} and "
                             f"{tuple(o.kr.shape)}")
        if o.n_frames < 1 or o.hop < 1 or o.y.shape[0] < need:
            raise ValueError(f"{o.n_frames} frames of hop {o.hop} and "
                             f"length {o.n_fft} need {need} samples, got "
                             f"{o.y.shape[0]}")
        if (o.out.dim() != 2 or o.out.shape[0] < o.n_frames or o.col < 0
                or o.col + bpo > o.out.shape[1] or o.scale.shape != (bpo,)):
            raise ValueError(f"columns {o.col}..{o.col + bpo} of "
                             f"{o.n_frames} rows do not fit out "
                             f"{tuple(o.out.shape)}, or scale "
                             f"{tuple(o.scale.shape)} is not ({bpo},)")
        tensors = [o.y, o.kr, o.scale, o.out] + (
            [] if o.bank is None else [o.bank])
        if any(t.device != dev for t in tensors):
            raise ValueError(f"work list tensors on {dev} and elsewhere")
    return dev


@functools.lru_cache(maxsize=None)
def _lib(source: Optional[str] = None) -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/cqt_octave.cu`` (or from
    ``source``, a variant of it), with its C interface typed."""
    lib = _build.load("cqt_octave", source)
    lib.cqt_octaves_launch.argtypes = [
        ctypes.POINTER(_Entry), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.cqt_octaves_launch.restype = ctypes.c_int
    lib.cqt_octaves_tile.argtypes = []
    lib.cqt_octaves_tile.restype = ctypes.c_int
    return lib


def cqt_octaves_launcher(octaves: Sequence[Octave], *, bpo: int):
    """Checks and packs a work list of CUDA tensors once; returns a function
    of no arguments that launches the kernel on the current stream for
    every ``MAX_ENTRIES`` entries, adding one to the counter
    ``k1.launches`` per launch, and raises if a launch fails."""
    dev = _check(octaves, bpo)
    if dev.type != "cuda":
        raise ValueError(f"no CQT octave kernel for {dev}")
    width = kernel_width(bpo)
    for o in octaves:
        if o.bank is None or o.bank.shape != (o.n_fft // KC, 2, KC // 4,
                                              width, 4):
            raise ValueError(f"want the bank in the kernel's layout "
                             f"(bank_for_kernel), got "
                             f"{None if o.bank is None else o.bank.shape}")
        if any(t.dtype != torch.float32 for t in (o.y, o.bank, o.scale,
                                                  o.out)):
            raise TypeError("want float32 y, bank, scale and out")
        if not (o.y.is_contiguous() and o.bank.is_contiguous()
                and o.scale.is_contiguous() and o.out.stride(1) == 1):
            raise ValueError("y, bank and scale must be contiguous, and "
                             "out's rows too")
        if o.n_fft % KC or o.n_fft > MAX_N_FFT:
            raise ValueError(f"kernel takes n_fft a multiple of {KC} up to "
                             f"{MAX_N_FFT}, got {o.n_fft}")
        if o.bank.data_ptr() % 16:
            raise ValueError("bank must be 16-byte aligned")
    lib = _lib()
    launches = []
    for first in range(0, len(octaves), MAX_ENTRIES):
        part = octaves[first:first + MAX_ENTRIES]
        order, starts = launch_plan(part, lib.cqt_octaves_tile())
        entries = (_Entry * len(part))(*[
            _Entry(o.y.data_ptr(), o.y.shape[0], o.bank.data_ptr(),
                   o.scale.data_ptr(), o.out.data_ptr(), o.hop, o.n_fft,
                   o.n_frames, o.col, o.out.stride(0))
            for o in (part[i] for i in order)])
        launches.append((entries, (ctypes.c_int * len(starts))(*starts),
                         len(part)))

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            for entries, starts, n in launches:
                rc = lib.cqt_octaves_launch(entries, starts, n, bpo, stream)
                if rc != 0:
                    raise RuntimeError(f"cqt_octaves kernel launch failed: "
                                       f"CUDA error {rc}")
                counters["k1.launches"] += 1

    return launch


def cqt_octaves(octaves: Sequence[Octave], *, bpo: int):
    """Fills each entry's columns of its ``out``: the octave's magnitudes
    times its scale (see :class:`Octave`).

    On the CPU this is :func:`cqt_octaves_reference`. On the card it
    launches the kernel once for every ``MAX_ENTRIES`` entries, on the
    current stream, or raises.
    """
    dev = _check(octaves, bpo)
    if dev.type == "cpu":
        cqt_octaves_reference(octaves, bpo=bpo)
    else:
        cqt_octaves_launcher(octaves, bpo=bpo)()



def cqt_octave_reference(y_padded, kr, *, hop, n_fft, bpo, n_frames):
    """Plain PyTorch version of one octave, on any device. Samples past
    the end of ``y_padded`` count as 0, as in the kernel."""
    need = (n_frames - 1) * hop + n_fft
    if y_padded.shape[0] < need:
        y_padded = torch.nn.functional.pad(
            y_padded, (0, need - y_padded.shape[0]))
    frames = y_padded.unfold(0, n_fft, hop)[:n_frames]     # (T, n_fft) view
    ri = frames @ kr                                        # (T, 2·bpo)
    re, im = ri[:, :bpo], ri[:, bpo:]
    return torch.sqrt(re * re + im * im + 1e-30)


def cqt_octave(y_padded, kr, *, hop, n_fft, bpo, n_frames):
    """One octave of CQT magnitudes, unscaled.

    Args:
        y_padded: (L,) float32, the octave's signal already reflect-padded
            by ``n_fft // 2``. ``L >= (n_frames - 1)·hop + n_fft`` must
            hold: every frame lies inside the signal.
        kr: (n_fft, 2·bpo) float32 kernel bank ``[Re | -Im]``.
    Returns: (n_frames, bpo) float32 magnitudes, on ``y_padded``'s device.

    On the CPU this is :func:`cqt_octave_reference`. On the card it is a
    one-entry :func:`cqt_octaves`, the bank copied to the host and laid
    out there on every call. No path of the package calls it: ``cqt``
    and ``hcqt`` hand their work lists to :func:`cqt_octaves`, with the
    banks laid out once per plan. It is kept for the tests of one octave.
    """
    dev = y_padded.device
    out = torch.empty((n_frames, bpo), dtype=torch.float32, device=dev)
    scale = torch.ones(bpo, dtype=torch.float32, device=dev)
    bank = None
    if dev.type == "cuda" and kr.shape == (n_fft, 2 * bpo):
        if n_fft % KC:
            raise ValueError(f"kernel takes n_fft a multiple of {KC}, got "
                             f"{n_fft}")
        bank = torch.as_tensor(bank_for_kernel(kr.cpu().numpy()), device=dev)
    octave = Octave(y_padded, kr, bank, scale, out, hop=hop, n_fft=n_fft,
                    n_frames=n_frames, col=0)
    dev = _check([octave], bpo)
    if dev.type == "cpu":
        return cqt_octave_reference(y_padded, kr, hop=hop, n_fft=n_fft,
                                    bpo=bpo, n_frames=n_frames)
    cqt_octaves([octave], bpo=bpo)
    return out
