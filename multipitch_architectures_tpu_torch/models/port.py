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
- attention ``in_proj`` / ``out_proj`` and the LSTM's weights kept in
  torch layout.
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


def _double_conv_indices(convdrop, alt_order=False):
    """The reference's ``double_conv`` Sequential: (conv1, bn1, conv2,
    bn2) at 0, 1, 3, 4 for ``convdrop=None``, at 0, 1, 4, 5 otherwise,
    and at 3, 1, 7, 5 in the ``alt_order`` layout (JAX
    ``models/port.py:352-359``)."""
    if alt_order:
        return (3, 1, 7, 5)
    return (0, 1, 3, 4) if convdrop is None else (0, 1, 4, 5)


def _double_conv(p, stats, key, out, convdrop, alt_order):
    c1, b1, c2, b2 = _double_conv_indices(convdrop, alt_order)
    q = f"{key}.double_conv"
    _conv(p["conv1"], f"{q}.{c1}", out)
    _bn(p["bn1"], stats["bn1"], f"{q}.{b1}", out)
    _conv(p["conv2"], f"{q}.{c2}", out)
    _bn(p["bn2"], stats["bn2"], f"{q}.{b2}", out)
    if "resize" in p:                                  # residual shortcut
        _conv(p["resize"], f"{key}.resize", out)


def _mha(p, key, out):
    out[f"{key}.in_proj_weight"] = np.asarray(p["in_proj_weight"])
    out[f"{key}.in_proj_bias"] = np.asarray(p["in_proj_bias"])
    out[f"{key}.out_proj.weight"] = np.asarray(p["out_proj_weight"])
    out[f"{key}.out_proj.bias"] = np.asarray(p["out_proj_bias"])


def _transformer_enc(p, key, out):
    for name in ("q_linear", "k_linear", "v_linear", "o_linear"):
        _dense(p[name], f"{key}.{name}", out)
    _mha(p["attn"], f"{key}.attn", out)
    _dense(p["mlp1"], f"{key}.mlp.0", out)
    _dense(p["mlp2"], f"{key}.mlp.2", out)
    _ln(p["layernorm1"], f"{key}.layernorm1", out)
    _ln(p["layernorm2"], f"{key}.layernorm2", out)
    if "pe" in p:                                     # learned encoding
        out[f"{key}.pe"] = np.asarray(p["pe"])


def _freq_attn_block(p, out):
    """The freq U-Net's inline attention block, whose modules the
    reference keeps at the model's top level: ``q_linear{s}`` ..
    ``attn{s}``, ``layernorm{i}``, ``mlp{j}.0`` / ``.2``,
    ``layernorm{j}``."""
    for name, sub in p.items():
        if name.startswith("attn"):
            _mha(sub, name, out)
        elif name.startswith("mlp"):                  # mlp{j}_1, mlp{j}_2
            j, k = name[3:].split("_")
            _dense(sub, f"mlp{j}.{0 if k == '1' else 2}", out)
        elif name.startswith("layernorm"):
            _ln(sub, name, out)
        else:                                         # q/k/v/o_linear{s}
            _dense(sub, name, out)


# the pitch head's convs: flax path below ``head`` -> torch module name;
# the freq U-Nets with attention keep the head as conv4..conv6
_HEAD_CONVS = {"conv2/conv": "conv2.0", "conv3/conv": "conv3.0",
               "conv4/conv": "conv4.0", "conv5": "conv4.3"}
_FREQ_ATTN_HEAD_CONVS = {"conv2/conv": "conv4.0", "conv3/conv": "conv5.0",
                         "conv4/conv": "conv6.0", "conv5": "conv6.3"}
# top-level convs kept under their own name, or their Sequential's first
_PLAIN_CONVS = {"conv5": "conv4.3", "convP1": "convP.0", "convP2": "convP.4",
                "conv5a": "conv5a", "conv5b": "conv5b", "conv3b": "conv3b",
                "reduction": "reduction.0"}


def state_dict_from_flax(variables, convdrop: Optional[float] = 0.0,
                         alt_order: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """flax variables of a model of the zoo (nested dicts of arrays under
    ``params`` and ``batch_stats``) -> this package's state_dict, by the
    key rules of the JAX package's ``export_state_dict``
    (models/port.py:374). ``convdrop`` and ``alt_order`` are the model's:
    they decide the DoubleConv indices.

    The freq U-Nets without attention (``FreqUNet``,
    ``FreqUNetBottomStack``) cannot be built upstream, so the reference
    has no names for them: their modules keep the JAX package's names
    (``down_conv1/conv`` -> ``down_conv1.0``, ``bottom/conv`` ->
    ``bottom.0``, ``conv3b``), which the JAX exporter does not cover."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    head = _FREQ_ATTN_HEAD_CONVS if "attnblock1" in params else _HEAD_CONVS
    out = {}
    for name, p in params.items():
        if name == "layernorm":
            _ln(p["ln"], "layernorm", out, transpose=True)
        elif name == "trunk":                     # the segmentation CNNs
            _ln(p["layernorm"]["ln"], "layernorm", out, transpose=True)
            _conv(p["conv1"]["conv"], "conv1.0", out)
        elif name.startswith("prefilt"):
            _conv(p["conv"], f"prefilt_list.{name[len('prefilt'):]}.0", out)
        elif name == "inc" or name.startswith("upconv"):
            _double_conv(p, stats[name], name, out, convdrop, alt_order)
        elif name.startswith("down") and "conv1" in p:
            # the reference's down{i} is Sequential(MaxPool2d, double_conv)
            _double_conv(p, stats[name], f"{name}.1", out, convdrop,
                         alt_order)
        elif name.startswith("attnblock"):
            _freq_attn_block(p, out)
        elif name.startswith("attention"):
            _transformer_enc(p, name, out)
        elif name.startswith("lstm"):
            for k, v in p["blstm"].items():
                out[f"{name}.blstm.{k}"] = np.asarray(v)
        elif name == "head":
            for path, key in head.items():
                sub, _, leaf = path.partition("/")
                _conv(p[sub][leaf] if leaf else p[sub], key, out)
        elif name in _PLAIN_CONVS:
            _conv(p, _PLAIN_CONVS[name], out)
        elif set(p) == {"bn", "conv"}:            # BN -> conv -> SELU
            _bn(p["bn"], stats[name]["bn"], f"{name}.0", out)
            _conv(p["conv"], f"{name}.1", out)
        elif set(p) == {"conv"}:                  # a conv block's conv
            _conv(p["conv"], f"{name}.0", out)
        else:
            raise KeyError(f"state_dict_from_flax: unknown module {name!r}")
    return {k: torch.tensor(v) for k, v in out.items()}


def torch_module_name(flax_path, convdrop: Optional[float] = 0.0,
                      alt_order: bool = False, freq_attn: bool = False
                      ) -> str:
    """A conv's module path in the JAX package (``"/"``-joined
    ``mod.path``) -> its name in this package, by the rules of
    :func:`state_dict_from_flax`, for every family of the zoo:

    - the U-Nets: ``inc/conv1`` -> ``inc.double_conv.0``, ``down1/conv2``
      -> ``down1.1.double_conv.4``, ``down1/resize`` -> ``down1.1.resize``
      (``convdrop`` and ``alt_order`` decide the indices), the polyphony
      heads' ``convP1`` / ``convP2`` -> ``convP.0`` / ``convP.4``,
      TransEnc's ``conv2/conv`` -> ``conv2.0`` and ``reduction`` ->
      ``reduction.0``;
    - the CNNs: ``trunk/conv1/conv`` -> ``conv1.0``, ``prefilt2/conv`` ->
      ``prefilt_list.2.0``, ``conv1/conv`` -> ``conv1.0``, ``conv5a``,
      ``conv5b``;
    - the freq U-Nets: ``down_conv1/conv`` -> ``down_conv1.0``,
      ``bottom/conv`` -> ``bottom.0``, ``conv3b``; with attention
      (``freq_attn``), ``conv1/conv`` -> ``conv1.0``, ``conv2/conv`` ->
      ``conv2.1`` (after its BN), ``up_conv3/conv`` -> ``up_conv3.1``;
    - the pitch head: ``head/conv2/conv`` -> ``conv2.0`` .. ``head/conv5``
      -> ``conv4.3`` (``conv4.0`` .. ``conv6.3`` with ``freq_attn``;
      top-level ``conv5`` -> ``conv4.3`` likewise).

    The JAX package's int8 policies (``activation_scales``, ``exclude``),
    keyed by module path, carry across with it. A path with no conv
    raises ``KeyError``."""
    path = flax_path if isinstance(flax_path, str) else "/".join(flax_path)
    top, _, rest = path.partition("/")
    if top == "head":
        head = _FREQ_ATTN_HEAD_CONVS if freq_attn else _HEAD_CONVS
        if rest in head:
            return head[rest]
    if top == "trunk" and rest == "conv1/conv":
        return "conv1.0"
    if top.startswith("prefilt") and top[7:].isdigit() and rest == "conv":
        return f"prefilt_list.{top[7:]}.0"
    if not rest and top in _PLAIN_CONVS:
        return _PLAIN_CONVS[top]
    if rest == "conv" and (top in ("conv1", "conv2", "conv3", "conv4",
                                   "bottom") or
                           top[:-1] in ("down_conv", "up_conv")):
        bn_first = freq_attn and top != "conv1"
        return f"{top}.{1 if bn_first else 0}"
    block = (top if top == "inc" or top.startswith("upconv")
             else f"{top}.1" if top.startswith("down") else None)
    if block is not None and rest == "resize":
        return f"{block}.resize"
    if block is not None and rest in ("conv1", "conv2"):
        c1, _, c2, _ = _double_conv_indices(convdrop, alt_order)
        return f"{block}.double_conv.{c1 if rest == 'conv1' else c2}"
    raise KeyError(f"torch_module_name: no conv {path!r} in the zoo")
