"""The zoo's 2-D convolution, its data gradient computed as a forward
convolution where the geometry allows.

For a stride-1, dilation-1, ungrouped conv with kernel ``k`` and zero
padding ``p <= k - 1`` (on each axis), the gradient with respect to the
input is exactly a forward convolution: the output's gradient convolved
with the weights flipped in both spatial axes, in and out channels
swapped, padded by ``k - 1 - p``. Every cuDNN forward algorithm is
deterministic, so under ``cudnn.deterministic`` (the trainer's default,
for bit-exact resume) this replaces cuDNN's direct deterministic
data-gradient kernel where cuDNN would take it (:func:`dgrad_as_forward`):
on the H100 that kernel ran 3 to 37 times slower than the forward
convolution that replaces it (PERF.md). The forward, the weight and the
bias gradients are the ones ``nn.Conv2d`` computes, bit for bit.

Counters (``utils.counters``): ``conv.dgrad_as_forward``, data
gradients computed so (counted in the backward);
``conv.dgrad_fallback``, convs whose geometry keeps autograd's own path
while the input requires a gradient (counted in the forward).
"""

import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ..utils.profiling import counters

_count_lock = threading.Lock()     # a mesh runs its shards in threads


def _count(name):
    with _count_lock:
        counters[name] += 1


def dgrad_as_forward(conv: nn.Conv2d) -> bool:
    """Whether ``conv``'s data gradient is computed as a forward
    convolution. It can be wherever the stride and dilation are 1, there
    is one group and the zero padding is at most ``k - 1`` on each axis
    (:class:`_Conv2dDgradAsForward` takes any such conv). It is where,
    besides, the padding keeps the map's size (``2p = k - 1``: the
    gradient does the forward's work), the kernel is at least 9 x 9 and
    the input has 16 to 32 channels: among the zoo's shapes, where
    cuDNN's deterministic data gradient ran its direct kernel,
    ``dgrad2d_alg1_1``, on the H100 (PERF.md). With wider inputs it
    took an FFT that outruns the forward convolution of the shape
    (DRCNN's 70-channel 15 x 15 convs: 2.4 ms against 52.5), with 6
    input channels the forward convolution that makes them runs at a
    third of cuDNN's FFT, and kernels of 5 x 5 and less run as fast
    either way."""
    kernel, padding = conv.kernel_size, conv.padding
    return (conv.stride == (1, 1) and conv.dilation == (1, 1)
            and conv.groups == 1 and conv.padding_mode == "zeros"
            and all(2 * p == k - 1 for p, k in zip(padding, kernel))
            and min(kernel) >= 9 and 16 <= conv.in_channels <= 32)


class _Conv2dDgradAsForward(torch.autograd.Function):
    """``F.conv2d`` at stride 1 whose backward computes the input
    gradient as the forward convolution of the output's gradient with the
    flipped, transposed weights, and the weight and bias gradients by
    ``aten.convolution_backward``, as autograd does."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        ctx.has_bias = bias is not None
        return F.conv2d(x, weight, bias, (1, 1), padding, (1, 1), 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        grad_x = grad_w = grad_b = None
        if need_x:
            kh, kw = weight.shape[2:]
            ph, pw = ctx.padding
            grad_x = F.conv2d(grad_out, weight.transpose(0, 1).flip(2, 3),
                              None, (1, 1), (kh - 1 - ph, kw - 1 - pw))
            _count("conv.dgrad_as_forward")
        if need_w or need_b:
            _, grad_w, grad_b = torch.ops.aten.convolution_backward(
                grad_out, x, weight,
                [weight.shape[0]] if ctx.has_bias else None, (1, 1),
                ctx.padding, (1, 1), False, (0, 0), 1,
                [False, need_w, need_b])
        return grad_x, grad_w, grad_b, None


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters, ``state_dict`` keys and
    forward) whose data gradient is a forward convolution wherever
    :func:`dgrad_as_forward` holds. Without a gradient to compute for the
    input (``no_grad``, or an input that requires none) the forward is
    ``nn.Conv2d``'s call."""

    def forward(self, x):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return super().forward(x)
        if not dgrad_as_forward(self):
            _count("conv.dgrad_fallback")
            return super().forward(x)
        return _Conv2dDgradAsForward.apply(x, self.weight, self.bias,
                                           self.padding)
