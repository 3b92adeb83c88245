"""Model summary: the role ``torchinfo.summary`` played in every
experiment script (parameter counts and mult-adds logged at startup,
exp180d…py:224-233). Counterpart of the JAX package's
``utils/summary.py``.

:func:`count_macs` runs the forward on the ``meta`` device under
``FlopCounterMode``: no memory is allocated and nothing is computed. It
counts convolutions and matrix products (the attention's score and value
products included, which old torchinfo missed) and halves the FLOPs, so
that it gives the JAX package's multiply-accumulates.
"""

from typing import Tuple

import torch


def count_macs(model, input_shape: Tuple[int, ...] = (1, 6, 174, 216),
               train: bool = False) -> int:
    """Total multiply-accumulates of one forward pass of ``model`` on an
    input of ``input_shape``: the role of torchinfo's 'Total mult-adds'
    in the reference logs (exp180d…py:233 logs
    ``summary(model, (1, 6, 174, 216))``). ``model`` stays where it is
    and as it is: the count runs a functional call with ``meta`` copies
    of its parameters and buffers."""
    from torch.func import functional_call
    from torch.utils.flop_counter import FlopCounterMode

    tensors = {name: torch.empty_like(t, device="meta")
               for name, t in list(model.named_parameters())
               + list(model.named_buffers())}
    x = torch.zeros(input_shape, device="meta")
    mode = model.training
    model.train(train)
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            functional_call(model, tensors, (x,))
    finally:
        model.train(mode)
    return counter.get_total_flops() // 2


def model_summary(model, input_shape: Tuple[int, ...] = (1, 6, 75, 216),
                  train: bool = False) -> str:
    """Each parameter's name, shape and size, the total, the BatchNorm
    statistics and the mult-adds (:func:`count_macs`) of ``model`` for
    an input of ``input_shape``, as text."""
    lines = [f"{type(model).__name__}  (input {input_shape})", "=" * 64]
    total = 0
    for name, p in model.named_parameters():
        total += p.numel()
        lines.append(f"{name:<48} {str(tuple(p.shape)):<18} "
                     f"{p.numel():>12,}")
    lines.append("=" * 64)
    lines.append(f"Total params: {total:,}")
    stats = sum(b.numel() for name, b in model.named_buffers()
                if name.endswith(("running_mean", "running_var")))
    if stats:
        lines.append(f"BatchNorm stats: {stats:,}")
    macs = count_macs(model, input_shape, train=train)
    lines.append(f"Total mult-adds (G): {macs / 1e9:.2f}")
    return "\n".join(lines)
