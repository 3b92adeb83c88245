"""The int8 GEMM: int8 x int8 -> int32 products, dense and as an
implicit-GEMM convolution, with an optional fused dequantize.

Counterpart of the int8 probe kernels
``perf/pallas_int8_matmul_probe.py :: pallas_int8_mm`` and
``pallas_int8_mm_acc``, and the arithmetic under every quantized conv of
the int8 serving mode (``eval/quant.py``), which the JAX package left to
XLA's ``conv_general_dilated(int8, int8, preferred_element_type=int32)``.

:func:`int8_mm`, :func:`int8_conv2d` and :func:`int8_conv2d_dequant`
launch the CUDA kernel ``csrc/int8_gemm.cu`` (wgmma, one mainloop, an
int32 or a fused-dequantize epilogue) for tensors on the card and take
the plain versions :func:`int8_mm_reference`,
:func:`int8_conv2d_reference` and :func:`int8_conv2d_dequant_reference`
for tensors on the CPU. The plain versions are exact: every partial sum
they form is an integer that their float type represents exactly, and
the dequantize rounds each float32 step as the kernel does.

The fused entry, which serving runs, goes through a registered operator,
``torch.ops.mpt_torch.int8_conv2d_dequant`` (a CPU and a CUDA
implementation and a fake one for shapes), so that ``torch.export``
keeps it as one node of an exported int8 serving artifact (``serve.py``).
"""

import ctypes
import functools
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import counters
from . import _build

CHANNEL_ALIGN = 16   # the kernel copies 16-byte chunks of one pixel, or
NARROW_ALIGN = 8     # 8-byte ones for inputs of at most 8 channels


def int8_mm_reference(a, b):
    """Plain version of :func:`int8_mm` on any device: the product in
    float64 (|sum| <= K·127² < 2^53)."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_conv2d_reference(xq, wq, stride=(1, 1), padding=(0, 0)):
    """Plain version of :func:`int8_conv2d` on any device: ``F.conv2d``.

    On the card it runs in float64 with cuDNN off, so that no FFT or
    Winograd algorithm rounds the integer sums. On the CPU, where float64
    convolutions are an order of magnitude slower, it runs in float32 on
    the two balanced base-16 digits of the activation (x = 16·hi + lo,
    |hi|, |lo| <= 8), with NNPACK (Winograd, FFT) off: every partial sum
    is an integer below K·8·127 < 2^24, so exact in any order, for K up
    to 16,513; a deeper K takes the float64 path there too.
    """
    x, w = xq.permute(0, 3, 1, 2), wq.permute(0, 3, 1, 2)
    kw = dict(stride=tuple(stride), padding=tuple(padding))
    if xq.device.type == "cpu" and w[0].numel() * 8 * 127 < 2 ** 24:
        x, w = x.float(), w.float()
        hi = torch.round(x / 16)
        with torch.backends.nnpack.flags(enabled=False):
            y = (F.conv2d(hi, w, **kw).to(torch.int32) * 16
                 + F.conv2d(x - 16 * hi, w, **kw).to(torch.int32))
    else:
        with torch.backends.cudnn.flags(enabled=False):
            y = F.conv2d(x.double(), w.double(), **kw).to(torch.int32)
    return y.permute(0, 2, 3, 1).contiguous()


def dequantize_reference(sums, s1, s2, bias=None):
    """The fused epilogue's plain version: int32 ``sums`` (..., Cout) as
    ``.float()``, ``mul_(s1)``, ``mul_(s2)`` and ``add_(bias)``, each a
    float32 pass rounded to nearest."""
    y = sums.float()
    y.mul_(s1)
    y.mul_(s2)
    if bias is not None:
        y.add_(bias)
    return y


def int8_conv2d_dequant_reference(xq, wq, stride, padding, s1, s2,
                                  bias=None):
    """Plain version of :func:`int8_conv2d_dequant` on any device: the
    exact int32 sums, then :func:`dequantize_reference`."""
    return dequantize_reference(
        int8_conv2d_reference(xq, wq, stride, padding), s1, s2, bias)


@functools.lru_cache(maxsize=None)
def _lib(source=None):
    """The kernel's library, built from ``csrc/int8_gemm.cu`` (or from
    ``source``, a variant of it), with its C entry points typed."""
    lib = _build.load("int8_gemm", source)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_mm_launch.argtypes = [ptr, ptr, ptr, i, i, i, ptr]
    lib.int8_conv2d_launch.argtypes = [ptr, ptr, ptr] + [i] * 11 + [ptr]
    lib.int8_conv2d_dequant_launch.argtypes = ([ptr, ptr, ptr] + [i] * 11
                                               + [ptr] * 4)
    for entry in ("int8_mm", "int8_conv2d", "int8_conv2d_dequant"):
        getattr(lib, f"{entry}_launch").restype = i
    return lib


def _pad_last(t, multiple):
    """Zero-pad the last dim of ``t`` up to a multiple of ``multiple``."""
    extra = -t.shape[-1] % multiple
    return F.pad(t, (0, extra)) if extra else t


def _check_card_operands(*ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"no int8 GEMM kernel for {t.device}")
        if not t.is_contiguous():
            raise ValueError("int8 GEMM operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("int8 GEMM operands must be 16-byte aligned")


def int8_mm(a, b):
    """C = A·B for int8 A (M, K) and B (K, N): (M, N) int32.

    On the CPU this is :func:`int8_mm_reference`. On the card it launches
    the kernel on the current stream, or raises; each launch adds one to
    the counter ``int8.mm_launches``. The kernel takes both operands
    K-contiguous, as the convolution does: B is transposed once, and K is
    zero-padded to a multiple of 16 where needed.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want A (M, K) and B (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"want int8, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"A on {a.device}, B on {b.device}")
    if a.device.type == "cpu":
        return int8_mm_reference(a, b)
    _check_card_operands(a, b)
    a = _pad_last(a, CHANNEL_ALIGN)
    bt = _pad_last(b.t().contiguous(), CHANNEL_ALIGN)
    (m, k), n = a.shape, bt.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().int8_mm_launch(
            a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_mm kernel launch failed: CUDA error {rc}")
    counters["int8.mm_launches"] += 1
    return out


def _conv_shape(xq, wq, stride, padding):
    """Checks a convolution's operands; returns (N, Ho, Wo, Cout)."""
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[3] != wq.shape[3]:
        raise ValueError(f"want xq (N, H, W, C) and wq (Cout, kh, kw, C), got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"want int8, got {xq.dtype} and {wq.dtype}")
    if xq.device != wq.device:
        raise ValueError(f"xq on {xq.device}, wq on {wq.device}")
    (sh, sw), (ph, pw) = stride, padding
    n, h, w, _ = xq.shape
    cout, kh, kw, _ = wq.shape
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    if min(sh, sw) < 1 or min(ph, pw) < 0 or ho < 1 or wo < 1:
        raise ValueError(f"stride {stride} and padding {padding} give an "
                         f"empty output for {h} x {w} and {kh} x {kw}")
    return n, ho, wo, cout


def pad_channels(xq, wq):
    """``xq`` and ``wq`` with their channels zero-padded as the kernel
    takes them: to 8 for at most 8 channels (the 6-channel first conv,
    copied in 8-byte pieces), else to a multiple of 16. Zero channels add
    nothing to the sums."""
    c = xq.shape[3]
    multiple = NARROW_ALIGN if c <= NARROW_ALIGN else CHANNEL_ALIGN
    return _pad_last(xq, multiple), _pad_last(wq, multiple)


def _launch_conv(entry, xq, wq, stride, padding, out, *extra):
    """Pads the operands, launches ``entry`` into ``out``, raises on a
    CUDA error. The weights go as (Cout, K) rows zero-padded to a multiple
    of 16 bytes."""
    _check_card_operands(xq, wq)
    xq, wq = pad_channels(xq, wq)
    cout, kh, kw, c = wq.shape
    wk = _pad_last(wq.reshape(cout, -1), CHANNEL_ALIGN)
    n, h, w, _ = xq.shape
    with torch.cuda.device(xq.device):
        rc = getattr(_lib(), f"{entry}_launch")(
            xq.data_ptr(), wk.data_ptr(), out.data_ptr(), n, h, w, c, cout,
            kh, kw, *stride, *padding, *extra,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


def int8_conv2d(xq, wq, stride=(1, 1), padding=(0, 0)):
    """int8 convolution with int32 sums, channels last.

    Args:
        xq: (N, H, W, C) int8 activation.
        wq: (Cout, kh, kw, C) int8 weights: the GEMM's B, K-contiguous.
        stride, padding: (sh, sw) and symmetric zero padding (ph, pw).
    Returns: (N, Ho, Wo, Cout) int32.

    On the CPU this is :func:`int8_conv2d_reference`. On the card it
    launches the kernel on the current stream, or raises; each launch
    adds one to the counter ``int8.conv_launches``. The kernel gathers its
    A tiles from ``xq`` itself (no im2col buffer); C is zero-padded as
    :func:`pad_channels` says.
    """
    shape = _conv_shape(xq, wq, stride, padding)
    if xq.device.type == "cpu":
        return int8_conv2d_reference(xq, wq, stride, padding)
    out = torch.empty(shape, dtype=torch.int32, device=xq.device)
    _launch_conv("int8_conv2d", xq, wq, stride, padding, out)
    counters["int8.conv_launches"] += 1
    return out


def _check_float(t, shape, what, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, the operands on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


@torch.library.custom_op("mpt_torch::int8_conv2d_dequant", mutates_args=(),
                         device_types="cpu")
def _int8_conv2d_dequant_op(xq: torch.Tensor, wq: torch.Tensor,
                            stride: List[int], padding: List[int],
                            s1: torch.Tensor, s2: torch.Tensor,
                            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The fused entry as a PyTorch operator, so that ``torch.export``
    keeps it as one node of a serving artifact. Its CPU implementation is
    the plain version; its CUDA one launches the kernel."""
    return int8_conv2d_dequant_reference(xq, wq, stride, padding, s1, s2,
                                         bias)


@_int8_conv2d_dequant_op.register_kernel("cuda")
def _int8_conv2d_dequant_launch(xq, wq, stride, padding, s1, s2, bias):
    out = torch.empty(_conv_shape(xq, wq, stride, padding),
                      dtype=torch.float32, device=xq.device)
    _launch_conv("int8_conv2d_dequant", xq, wq, stride, padding, out,
                 s1.data_ptr(), s2.data_ptr(),
                 None if bias is None else bias.data_ptr())
    counters["int8.conv_dequant_launches"] += 1
    return out


@_int8_conv2d_dequant_op.register_fake
def _int8_conv2d_dequant_fake(xq, wq, stride, padding, s1, s2, bias):
    return xq.new_empty(_conv_shape(xq, wq, stride, padding),
                        dtype=torch.float32)


def int8_conv2d_dequant(xq, wq, stride, padding, s1, s2, bias=None):
    """:func:`int8_conv2d` with the dequantize fused into the kernel's
    epilogue: float32 (N, Ho, Wo, Cout) ``((float(sums) · s1) · s2) +
    bias``, each step rounded to nearest, bit-equal to the unfused passes.

    Args:
        xq, wq, stride, padding: as :func:`int8_conv2d`.
        s1: (Cout,) float32 scales; s2: a 0-dim float32 scale; bias:
            (Cout,) float32 or None. All on the operands' device.

    Checks its operands, then calls the operator
    ``torch.ops.mpt_torch.int8_conv2d_dequant``: on the CPU
    :func:`int8_conv2d_dequant_reference`; on the card a launch of the
    kernel on the current stream, or a raise. Each launch adds one to the
    counter ``int8.conv_dequant_launches``, also from inside an exported
    program.
    """
    shape = _conv_shape(xq, wq, stride, padding)
    cout = (shape[3],)
    _check_float(s1, cout, "s1", xq.device)
    _check_float(s2, (), "s2", xq.device)
    if bias is not None:
        _check_float(bias, cout, "bias", xq.device)
    return torch.ops.mpt_torch.int8_conv2d_dequant(
        xq, wq, list(stride), list(padding), s1, s2, bias)
