"""Weight bridge: the JAX package's flax variables -> this package's
``state_dict``.

The port's modules carry the reference's ``state_dict`` key names, so the
result loads with ``load_state_dict(strict=True)`` and the same loader
will take the reference's published ``.pt`` files. The layout rules are
those of the JAX package's ``export_state_dict`` (models/port.py:303-374),
in numpy only:

- conv kernels HWIO -> OIHW; dense kernels transposed;
- the harmonic LayerNorm affine (F, C) -> (C, F);
- BatchNorm scale/bias with running mean/var;
- attention ``in_proj`` / ``out_proj`` kept in torch layout.
"""

from typing import Dict, Optional

import numpy as np
import torch


def _conv(p, key, out):
    out[f"{key}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{key}.bias"] = np.asarray(p["bias"])


def _dense(p, key, out):
    out[f"{key}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{key}.bias"] = np.asarray(p["bias"])


def _ln(p, key, out, transpose=False):
    scale, bias = np.asarray(p["scale"]), np.asarray(p["bias"])
    out[f"{key}.weight"] = scale.T if transpose else scale
    out[f"{key}.bias"] = bias.T if transpose else bias


def _bn(p, stats, key, out):
    _ln(p, key, out)
    out[f"{key}.running_mean"] = np.asarray(stats["mean"])
    out[f"{key}.running_var"] = np.asarray(stats["var"])
    out[f"{key}.num_batches_tracked"] = np.asarray(0)


def _double_conv_indices(convdrop):
    """The reference's ``double_conv`` Sequential: convs and BNs at
    0, 1, 3, 4 for ``convdrop=None`` and at 0, 1, 4, 5 otherwise."""
    return (0, 1, 3, 4) if convdrop is None else (0, 1, 4, 5)


def _double_conv(p, stats, key, out, convdrop):
    c1, b1, c2, b2 = _double_conv_indices(convdrop)
    q = f"{key}.double_conv"
    _conv(p["conv1"], f"{q}.{c1}", out)
    _bn(p["bn1"], stats["bn1"], f"{q}.{b1}", out)
    _conv(p["conv2"], f"{q}.{c2}", out)
    _bn(p["bn2"], stats["bn2"], f"{q}.{b2}", out)


def _transformer_enc(p, key, out):
    for name in ("q_linear", "k_linear", "v_linear", "o_linear"):
        _dense(p[name], f"{key}.{name}", out)
    attn = p["attn"]
    out[f"{key}.attn.in_proj_weight"] = np.asarray(attn["in_proj_weight"])
    out[f"{key}.attn.in_proj_bias"] = np.asarray(attn["in_proj_bias"])
    out[f"{key}.attn.out_proj.weight"] = np.asarray(attn["out_proj_weight"])
    out[f"{key}.attn.out_proj.bias"] = np.asarray(attn["out_proj_bias"])
    _dense(p["mlp1"], f"{key}.mlp.0", out)
    _dense(p["mlp2"], f"{key}.mlp.2", out)
    _ln(p["layernorm1"], f"{key}.layernorm1", out)
    _ln(p["layernorm2"], f"{key}.layernorm2", out)
    if "pe" in p:                                     # learned encoding
        out[f"{key}.pe"] = np.asarray(p["pe"])


def state_dict_from_flax(variables, convdrop: Optional[float] = 0.0
                         ) -> Dict[str, torch.Tensor]:
    """flax variables of a SAUnet-family model (nested dicts of arrays
    under ``params`` and ``batch_stats``) -> this package's state_dict.
    ``convdrop`` is the model's: it decides the DoubleConv indices."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = {}
    for name, p in params.items():
        if name == "layernorm":
            _ln(p["ln"], "layernorm", out, transpose=True)
        elif name == "inc" or name.startswith("upconv"):
            _double_conv(p, stats[name], name, out, convdrop)
        elif name.startswith("down"):
            # the reference's down{i} is Sequential(MaxPool2d, double_conv)
            _double_conv(p, stats[name], f"{name}.1", out, convdrop)
        elif name.startswith("attention"):
            _transformer_enc(p, name, out)
        elif name == "head":
            _conv(p["conv2"]["conv"], "conv2.0", out)
            _conv(p["conv3"]["conv"], "conv3.0", out)
            _conv(p["conv4"]["conv"], "conv4.0", out)
            _conv(p["conv5"], "conv4.3", out)
        else:
            raise KeyError(f"state_dict_from_flax: unknown module {name!r}")
    return {k: torch.tensor(v) for k, v in out.items()}


# the pitch head's convs: flax path below ``head`` -> torch module name
_HEAD_CONVS = {"conv2/conv": "conv2.0", "conv3/conv": "conv3.0",
               "conv4/conv": "conv4.0", "conv5": "conv4.3"}


def torch_module_name(flax_path, convdrop: Optional[float] = 0.0) -> str:
    """A SAUnet-family conv's module path in the JAX package (``"/"``-joined
    ``mod.path``, e.g. ``inc/conv1``, ``down1/conv2``, ``head/conv2/conv``)
    -> its name in this package (``inc.double_conv.0``,
    ``down1.1.double_conv.4``, ``conv2.0``), by the rules of
    :func:`state_dict_from_flax`. The JAX package's int8 policies
    (``activation_scales``, ``exclude``), keyed by module path, carry
    across with it."""
    path = flax_path if isinstance(flax_path, str) else "/".join(flax_path)
    top, _, rest = path.partition("/")
    if top == "head" and rest in _HEAD_CONVS:
        return _HEAD_CONVS[rest]
    if rest in ("conv1", "conv2"):
        c1, _, c2, _ = _double_conv_indices(convdrop)
        index = c1 if rest == "conv1" else c2
        if top == "inc" or top.startswith("upconv"):
            return f"{top}.double_conv.{index}"
        if top.startswith("down"):
            return f"{top}.1.double_conv.{index}"
    raise KeyError(f"torch_module_name: no conv {path!r} in the SAUnet family")
