"""Random weights from the run's seed, made on the device in one draw,
the same tensors handed to the program and to the reference.

Two laws, named by a configuration's ``weights_law``:

- ``he_uniform`` (serving): convolutions and linears He-uniform,
  U(±sqrt(6 / fan_in)), so that a deep random network still gives
  outputs that vary, and biases U(±1 / sqrt(fan_in)); the attention's
  packed input projection Xavier-uniform with zero bias;
- ``lecun_normal`` (training): the law that the run CLI's
  ``Trainer.init`` draws from, flax's defaults: convolutions and linears
  LeCun truncated normal (std sqrt(1 / fan_in) / 0.8796, cut at ±2 of
  it) with zero biases; the attention's input and output projections
  Xavier-uniform with zero biases. Under He-uniform weights one AdamW
  step saturates every output of SAUnet:L on some seeds, and the loss's
  clip then stops every gradient: training that no user runs.

Both: norms unit scale and zero shift; BatchNorm statistics (0, 1);
LSTMs PyTorch's default, every weight and bias U(±1 / sqrt(hidden)),
with zero biases under ``lecun_normal`` (flax's LSTM cell's). An
attention is any module that holds a packed ``in_proj_weight``.
"""

import math

import torch
from torch import nn

from .common import stream_seed

LAWS = ("he_uniform", "lecun_normal")
TRUNC_STD = 0.87962566103423978     # std of a unit normal cut at ±2


def _rules(model, law):
    """{parameter name: ("uniform" | "normal", scale) or ("const",
    value)}: a uniform bound, or a truncated normal's std."""
    if law not in LAWS:
        raise ValueError(f"unknown weights law {law!r}")
    out = {}
    xavier = set()
    for prefix, m in model.named_modules():
        def name(p):
            return f"{prefix}.{p}" if prefix else p

        if getattr(m, "in_proj_weight", None) is not None:
            e = m.in_proj_weight.shape[1]
            out[name("in_proj_weight")] = ("uniform",
                                           math.sqrt(6.0 / (e + 3 * e)))
            out[name("in_proj_bias")] = ("const", 0.0)
            if law == "lecun_normal":
                xavier.add(name("out_proj"))
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            if prefix in xavier:
                fan_out = m.weight.shape[0]
                out[name("weight")] = ("uniform",
                                       math.sqrt(6.0 / (fan_in + fan_out)))
            elif law == "lecun_normal":
                out[name("weight")] = ("normal",
                                       math.sqrt(1.0 / fan_in) / TRUNC_STD)
            else:
                out[name("weight")] = ("uniform", math.sqrt(6.0 / fan_in))
            if m.bias is not None:
                out[name("bias")] = ("const", 0.0) \
                    if law == "lecun_normal" or prefix in xavier \
                    else ("uniform", 1.0 / math.sqrt(fan_in))
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p, _ in m.named_parameters(recurse=False):
                out[name(p)] = ("const", 0.0) \
                    if law == "lecun_normal" and p.startswith("bias") \
                    else ("uniform", bound)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            out[name("weight")] = ("const", 1.0)
            out[name("bias")] = ("const", 0.0)
            if isinstance(m, nn.BatchNorm2d):
                out[name("running_mean")] = ("const", 0.0)
                out[name("running_var")] = ("const", 1.0)
                out[name("num_batches_tracked")] = ("const", 0)
    return out


def draw(model, seed, device, law="he_uniform"):
    """A state dict for ``model`` (the reference, on any device, the meta
    device included) drawn from ``seed`` on ``device`` by ``law``."""
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in model.state_dict().items()}
    rules = _rules(model, law)
    missing = set(shapes) - set(rules)
    if missing:
        raise KeyError(f"no rule for {sorted(missing)}")
    rand = [k for k in shapes if rules[k][0] != "const"]
    sizes = [math.prod(shapes[k][0]) for k in rand]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    u = torch.rand(sum(sizes), generator=gen, device=device)

    def per_element(values):
        return torch.repeat_interleave(
            torch.tensor(values, device=device),
            torch.tensor(sizes, device=device))

    scale = per_element([rules[k][1] for k in rand])
    normal = per_element([rules[k][0] == "normal" for k in rand])
    # a unit normal cut at ±2 by its inverse distribution function
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
    cut = torch.special.ndtri(lo + u * (1.0 - 2.0 * lo)).clamp_(-2.0, 2.0)
    u = torch.where(normal, cut, u.mul(2.0).sub_(1.0)).mul_(scale)
    sd = {k: p.view(shapes[k][0])
          for k, p in zip(rand, torch.split(u, sizes))}
    for k, (shape, dtype) in shapes.items():
        if k not in sd:
            sd[k] = torch.full(shape, rules[k][1], dtype=dtype,
                               device=device)
    return sd
