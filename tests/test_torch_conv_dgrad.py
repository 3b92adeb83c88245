"""The zoo's conv (``ops/conv.py``): the data gradient of a stride-1
conv computed as a forward convolution of the output's gradient with the
flipped, transposed weights.

- the mechanism, at every conv geometry that exp180d and the zoo use, in
  float64: the input gradient equals autograd's through ``F.conv2d``
  within 1e-12 relative, the forward, the weight and the bias gradients
  are bit-equal, and two backward passes are bit-equal;
- the rule: the module takes the mechanism exactly where
  ``dgrad_as_forward`` holds, and autograd's own path (counted as a
  fallback) elsewhere, strided, dilated and grouped convs included;
  nothing is counted or changed without a gradient for the input;
- every class of the zoo builds its convs as the port's ``Conv2d``, an
  ``nn.Conv2d`` with ``nn.Conv2d``'s ``state_dict`` keys;
- an exp180d backward (on the ``meta`` device) routes the convs that the
  rule names, and counts one fallback for each other conv.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from multipitch_architectures_tpu_torch.experiments import (
    MODEL_REGISTRY, load_experiment)
from multipitch_architectures_tpu_torch.models import cnns, layers, unets
from multipitch_architectures_tpu_torch.ops.conv import (
    Conv2d, _Conv2dDgradAsForward, dgrad_as_forward)
from multipitch_architectures_tpu_torch.utils import counters

AS_FORWARD, FALLBACK = "conv.dgrad_as_forward", "conv.dgrad_fallback"

# name: (in channels, out channels, kernel, padding, input (H, W))
GEOMETRIES = {
    "15x15-same": (3, 4, (15, 15), (7, 7), (18, 20)),
    "9x9-same": (3, 4, (9, 9), (4, 4), (11, 13)),
    "5x5-same": (3, 4, (5, 5), (2, 2), (7, 9)),
    "3x3-same": (3, 4, (3, 3), (1, 1), (5, 6)),
    "75x1-unpadded": (3, 4, (75, 1), (0, 0), (80, 5)),
    "1x1": (3, 4, (1, 1), (0, 0), (4, 5)),
    "2x5-polyphony": (3, 4, (2, 5), (0, 0), (4, 13)),
    "2x3-polyphony": (3, 4, (2, 3), (0, 0), (2, 5)),
}


def _counts():
    return counters[AS_FORWARD], counters[FALLBACK]


def _moved(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _operands(c_in, c_out, kernel, hw, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c_in, *hw, dtype=dtype, generator=g)
    w = torch.randn(c_out, c_in, *kernel, dtype=dtype, generator=g)
    b = torch.randn(c_out, dtype=dtype, generator=g)
    return [t.requires_grad_() for t in (x, w, b)]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_input_gradient_is_a_forward_convolution(geometry):
    c_in, c_out, kernel, padding, hw = GEOMETRIES[geometry]
    x, w, b = _operands(c_in, c_out, kernel, hw)
    y = F.conv2d(x, w, b, 1, padding)
    gy = torch.randn(y.shape, dtype=y.dtype,
                     generator=torch.Generator().manual_seed(1))
    want = torch.autograd.grad(y, (x, w, b), gy)
    before = _counts()
    got_y = _Conv2dDgradAsForward.apply(x, w, b, padding)
    got = torch.autograd.grad(got_y, (x, w, b), gy)
    assert torch.equal(got_y, y)
    assert _moved(before) == (1, 0)
    assert got[0].shape == x.shape
    rel = (got[0] - want[0]).abs().max() / want[0].abs().max()
    assert rel <= 1e-12, rel
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    again = torch.autograd.grad(
        _Conv2dDgradAsForward.apply(x, w, b, padding), (x, w, b), gy)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_only_the_gradients_asked_for():
    """A frozen weight and no bias: the input gradient alone, and no
    weight or bias gradient computed."""
    x, w, _ = _operands(3, 4, (3, 3), (5, 6))
    y = _Conv2dDgradAsForward.apply(x, w.detach(), None, (1, 1))
    (gx,) = torch.autograd.grad(y.sum(), (x,))
    want = torch.autograd.grad(F.conv2d(x, w.detach(), None, 1, 1).sum(),
                               (x,))[0]
    assert torch.allclose(gx, want, rtol=1e-12, atol=0)


# (in channels, out channels, kernel), the other arguments, routed: the
# first two are routed, each other one keeps autograd's path
RULE = {
    "routed-16ch-15x15": ((16, 4, (15, 15)), dict(padding=(7, 7)), True),
    "routed-32ch-9x9": ((32, 4, (9, 9)), dict(padding=(4, 4)), True),
    "6ch-15x15": ((6, 4, (15, 15)), dict(padding=(7, 7)), False),
    "64ch-15x15": ((64, 4, (15, 15)), dict(padding=(7, 7)), False),
    "16ch-5x5": ((16, 4, (5, 5)), dict(padding=(2, 2)), False),
    "16ch-9x9-unpadded": ((16, 4, (9, 9)), {}, False),
    "16ch-1x1": ((16, 4, (1, 1)), {}, False),
    "stride-1x3": ((16, 4, (9, 9)), dict(padding=(4, 4), stride=(1, 3)),
                   False),
    "dilation-2": ((16, 4, (9, 9)), dict(padding=(8, 8), dilation=2),
                   False),
    "groups-2": ((16, 4, (9, 9)), dict(padding=(4, 4), groups=2), False),
    "reflect-padding": ((16, 4, (9, 9)), dict(padding=(4, 4),
                                             padding_mode="reflect"), False),
}


@pytest.mark.parametrize("case", RULE)
def test_the_rule_and_its_fallback(case):
    """The module routes where ``dgrad_as_forward`` holds and keeps
    autograd's path elsewhere: the same output, the same weight and bias
    gradients bit for bit, the input gradient equal up to the summation
    order (bit-equal on autograd's path)."""
    args, kwargs, routed = RULE[case]
    torch.manual_seed(0)
    conv = Conv2d(*args, **kwargs).double()
    plain = nn.Conv2d(*args, **kwargs).double()
    plain.load_state_dict(conv.state_dict())
    assert dgrad_as_forward(conv) is routed
    x = torch.randn(2, args[0], 11, 13, dtype=torch.float64,
                    requires_grad=True)
    y_plain = plain(x)
    gy = torch.randn_like(y_plain)
    want = torch.autograd.grad(y_plain, (x, plain.weight, plain.bias), gy)
    before = _counts()
    y = conv(x)
    got = torch.autograd.grad(y, (x, conv.weight, conv.bias), gy)
    assert _moved(before) == ((1, 0) if routed else (0, 1))
    assert torch.equal(y, y_plain)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if routed:
        rel = (got[0] - want[0]).abs().max() / want[0].abs().max()
        assert rel <= 1e-12, rel
    else:
        assert torch.equal(got[0], want[0])


def test_no_gradient_no_route():
    """Under ``no_grad``, and for an input that requires no gradient,
    the module is ``nn.Conv2d``'s call: the same bits, no counter
    moved."""
    torch.manual_seed(0)
    conv = Conv2d(16, 4, (9, 9), padding=(4, 4))
    x = torch.randn(2, 16, 11, 13)
    want = F.conv2d(x, conv.weight, conv.bias, 1, (4, 4))
    before = _counts()
    with torch.no_grad():
        assert torch.equal(conv(x.requires_grad_()), want)
    assert torch.equal(conv(x.detach()), want)
    assert _moved(before) == (0, 0)


def test_two_backward_passes_are_bit_equal():
    """float32, a routed conv in a small stack: the same gradients each
    time."""
    torch.manual_seed(0)
    net = nn.Sequential(nn.BatchNorm2d(6), Conv2d(6, 16, 3, padding=1),
                        nn.ReLU(), Conv2d(16, 8, (9, 9), padding=(4, 4)))
    x = torch.randn(3, 6, 20, 24)

    def grads():
        net.zero_grad(set_to_none=True)
        net(x).square().sum().backward()
        return [p.grad.clone() for p in net.parameters()]

    before = _counts()
    first, second = grads(), grads()
    assert _moved(before) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_every_zoo_class_builds_the_port_conv(name, monkeypatch):
    """Every conv of the class is the port's ``Conv2d`` (an
    ``nn.Conv2d``), and its ``state_dict`` keys and shapes are those of
    the same class built with ``nn.Conv2d``."""
    cls = MODEL_REGISTRY[name]
    with torch.device("meta"):
        model = cls()
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    assert convs and all(type(m) is Conv2d for m in convs)
    for module in (layers, unets, cnns):
        monkeypatch.setattr(module, "Conv2d", nn.Conv2d)
    with torch.device("meta"):
        plain = cls()
    assert not any(isinstance(m, Conv2d) for m in plain.modules())
    ours, theirs = model.state_dict(), plain.state_dict()
    assert list(ours) == list(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)


def test_exp180d_backward_routes_the_rule():
    """SAUnet:L at full width on the ``meta`` device: one backward
    computes the data gradient of each conv that the rule names as a
    forward convolution and counts every other conv as a fallback (its
    input requires a gradient: the model starts with a LayerNorm)."""
    cfg = load_experiment(
        "exp180d_musicnet_unet_extremelylarge_doubleselfattn")
    with torch.device("meta"):
        # the sinusoidal table is made from numpy, on the CPU: moved too
        model = cfg.build_model().to("meta").train()
        x = torch.empty(2, 6, 75, 216)
    names = [n for n, m in model.named_modules() if isinstance(m, Conv2d)]
    routed = [n for n, m in model.named_modules()
              if isinstance(m, Conv2d) and dgrad_as_forward(m)]
    assert routed == ["inc.double_conv.4", "down1.1.double_conv.0",
                      "down1.1.double_conv.4", "down2.1.double_conv.0",
                      "upconv3.double_conv.4", "upconv4.double_conv.0",
                      "upconv4.double_conv.4"]
    before = _counts()
    model(x).sum().backward()
    assert _moved(before) == (len(routed), len(names) - len(routed)) \
        == (7, 15)
