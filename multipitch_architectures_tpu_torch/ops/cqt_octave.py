"""The CQT octave kernel: framing, kernel-bank product and magnitude in one.

Counterpart of ``multipitch_architectures_tpu/ops/pallas_cqt.py``. For one
octave, ``mag[t, k] = sqrt(re² + im² + 1e-30)`` where
``[re | im] = y_padded[t·hop : t·hop + n_fft] @ kr`` and
``kr = [Re K | -Im K]`` has shape ``(n_fft, 2·bpo)``.

:func:`cqt_octave` launches the CUDA kernel ``csrc/cqt_octave.cu`` for a
tensor on the card and takes the plain version
:func:`cqt_octave_reference` for a tensor on the CPU.
"""

import ctypes
import functools

import torch

from . import _build

KC = 32          # the kernel's K step: n_fft must be a multiple of it
MAX_BPO = 64     # bins per octave the kernel's shared tile holds


def cqt_octave_reference(y_padded, kr, *, hop, n_fft, bpo, n_frames):
    """Plain PyTorch version of the kernel, on any device. Samples past
    the end of ``y_padded`` count as 0, as in the kernel."""
    need = (n_frames - 1) * hop + n_fft
    if y_padded.shape[0] < need:
        y_padded = torch.nn.functional.pad(
            y_padded, (0, need - y_padded.shape[0]))
    frames = y_padded.unfold(0, n_fft, hop)[:n_frames]     # (T, n_fft) view
    ri = frames @ kr                                        # (T, 2·bpo)
    re, im = ri[:, :bpo], ri[:, bpo:]
    return torch.sqrt(re * re + im * im + 1e-30)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("cqt_octave")
    lib.cqt_octave_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.cqt_octave_launch.restype = ctypes.c_int
    return lib


def cqt_octave(y_padded, kr, *, hop, n_fft, bpo, n_frames):
    """One octave of CQT magnitudes.

    Args:
        y_padded: (L,) float32, the octave's signal already reflect-padded
            by ``n_fft // 2``. ``L >= (n_frames - 1)·hop + n_fft`` must
            hold: every frame lies inside the signal.
        kr: (n_fft, 2·bpo) float32 kernel bank ``[Re | -Im]``.
    Returns: (n_frames, bpo) float32 magnitudes, on ``y_padded``'s device.

    On the CPU this is :func:`cqt_octave_reference`. On the card it
    launches the kernel on the current stream, or raises; each launch
    adds one to ``cqt_octave.launches``.
    """
    if y_padded.dim() != 1 or kr.shape != (n_fft, 2 * bpo):
        raise ValueError(f"want y_padded (L,) and kr ({n_fft}, {2 * bpo}), "
                         f"got {tuple(y_padded.shape)} and "
                         f"{tuple(kr.shape)}")
    need = (n_frames - 1) * hop + n_fft
    if n_frames < 1 or hop < 1 or y_padded.shape[0] < need:
        raise ValueError(f"{n_frames} frames of hop {hop} and length "
                         f"{n_fft} need {need} samples, got "
                         f"{y_padded.shape[0]}")
    if y_padded.device != kr.device:
        raise ValueError(f"y_padded on {y_padded.device}, kr on {kr.device}")
    if y_padded.device.type == "cpu":
        return cqt_octave_reference(y_padded, kr, hop=hop, n_fft=n_fft,
                                    bpo=bpo, n_frames=n_frames)
    if y_padded.device.type != "cuda":
        raise ValueError(f"no CQT octave kernel for {y_padded.device}")
    if y_padded.dtype != torch.float32 or kr.dtype != torch.float32:
        raise TypeError(f"want float32, got {y_padded.dtype} and {kr.dtype}")
    if not (y_padded.is_contiguous() and kr.is_contiguous()):
        raise ValueError("y_padded and kr must be contiguous")
    if n_fft % KC or not 1 <= bpo <= MAX_BPO:
        raise ValueError(f"kernel takes n_fft a multiple of {KC} and bpo in "
                         f"[1, {MAX_BPO}], got n_fft={n_fft}, bpo={bpo}")
    out = torch.empty((n_frames, bpo), dtype=torch.float32,
                      device=y_padded.device)
    with torch.cuda.device(y_padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cqt_octave_launch(
            y_padded.data_ptr(), y_padded.shape[0], kr.data_ptr(),
            out.data_ptr(), n_frames, hop, n_fft, bpo, stream)
    if rc != 0:
        raise RuntimeError(f"cqt_octave kernel launch failed: CUDA error {rc}")
    cqt_octave.launches += 1
    return out


cqt_octave.launches = 0
