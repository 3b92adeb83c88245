"""Multi-head attention in ``nn.MultiheadAttention``'s weight layout, with
the reference's runtime semantics.

Counterpart of ``multipitch_architectures_tpu/ops/attention.py``. The
reference feeds ``(batch, tokens, embed)`` tensors into a layer that
expects ``(seq, batch, embed)``, so its models attend across batch
samples at each token position. Modes:

- ``cross_batch``: attention over the batch axis, as published;
- ``cross_batch:<g>``: the same within consecutive groups of ``g``
  samples (the whole batch when it is smaller than ``g``), so a batch of
  ``k·g`` windows gives the outputs of ``k`` separate ``g``-sized batches;
- ``tokens``: attention over the tokens of each sample.

Inside a sharded call (``parallel``), the batch axis is the global
batch of every data shard: a shard attends from its rows over the keys
and values of the whole batch, or of its rows' groups, gathered across
the data shards; groups that lie whole on a shard stay local.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives


def sinusoidal_positional_encoding(max_len: int, embed_dim: int) -> np.ndarray:
    """The reference's sinusoidal table (max_len, embed_dim), float32."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, embed_dim, 2, dtype=np.float64)
                      * (-np.log(10000.0) / embed_dim))
    pe = np.zeros((max_len, embed_dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def _attend(q, k, v, num_heads, mask=None):
    """Scaled dot-product attention over axis 1 of (N, Lq, E) queries and
    (N, Lk, E) keys and values: matmul, softmax, matmul, in the inputs'
    type. ``mask`` (Lq, Lk), True where a query may attend a key."""
    n, lq, e = q.shape
    hd = e // num_heads

    def split(t):  # (N, L, E) -> (N, H, L, hd)
        return t.reshape(n, t.shape[1], num_heads, hd).transpose(1, 2)

    qh, kh, vh = split(q) * (1.0 / math.sqrt(hd)), split(k), split(v)
    logits = qh @ kh.transpose(-1, -2)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    return (weights @ vh).transpose(1, 2).reshape(n, lq, e)


def _cross_batch_sharded(q, k, v, g, num_heads, ctx):
    """Cross-batch attention of this data shard's rows of the global
    batch (every shard holds as many): within groups of ``g`` consecutive
    rows of the global batch (the whole of it for None). Groups that lie
    whole on the shard attend locally; otherwise the keys and values of
    every shard are gathered, and the shard's rows attend over the rows
    of their own groups."""
    b = q.shape[0]
    total = b * ctx.n_data
    g = total if g is None else min(g, total)
    if total % g:
        raise ValueError(f"global batch {total} not a multiple of attention "
                         f"group {g}")
    if b % g == 0:
        return _grouped(q, k, v, g, num_heads)
    k, v = (collectives.all_gather(t, "data") for t in (k, v))
    first = ctx.data * b
    lo, hi = first // g * g, -(-(first + b) // g) * g
    mask = None
    if hi - lo > g:
        rows = torch.arange(first, first + b, device=q.device) // g
        keys = torch.arange(lo, hi, device=q.device) // g
        mask = rows[:, None] == keys[None, :]
    return _attend(q.transpose(0, 1), k[lo:hi].transpose(0, 1),
                   v[lo:hi].transpose(0, 1), num_heads, mask).transpose(0, 1)


def _grouped(q, k, v, g, num_heads):
    """Attention over the batch axis within consecutive groups of ``g``
    samples of a (B, S, E) batch, B a multiple of ``g``."""
    b, s, e = q.shape
    ng = b // g

    def regroup(t):  # (B, S, E) -> (ng·S, g, E)
        return (t.reshape(ng, g, s, t.shape[2]).transpose(1, 2)
                .reshape(ng * s, g, t.shape[2]))

    out = _attend(regroup(q), regroup(k), regroup(v), num_heads)
    return out.reshape(ng, s, g, e).transpose(1, 2).reshape(b, s, e)


def _parse_mode(mode: str):
    """``mode`` -> group size: None for ``cross_batch``, g for
    ``cross_batch:<g>``, 0 for ``tokens``."""
    if mode == "cross_batch":
        return None
    if mode.startswith("cross_batch:"):
        g = int(mode.split(":", 1)[1])
        if g < 1:
            raise ValueError(f"attention group must be >= 1: {mode!r}")
        return g
    if mode == "tokens":
        return 0
    raise ValueError(f"unknown attention mode: {mode!r}")


class TorchMultiheadAttention(nn.Module):
    """MHA core in torch's packed layout. Input and output ``(B, S, E)``.

    Parameters: ``in_proj_weight`` (3E, E) with rows q; k; v,
    ``in_proj_bias`` (3E,) and ``out_proj`` (E -> E).
    """

    def __init__(self, embed_dim: int, num_heads: int = 8,
                 mode: str = "cross_batch"):
        super().__init__()
        self.embed_dim, self.num_heads, self.mode = embed_dim, num_heads, mode
        self._group = _parse_mode(mode)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q, k, v = F.linear(q, wq, bq), F.linear(k, wk, bk), F.linear(v, wv, bv)
        g = self._group
        ctx = collectives.current()
        if g == 0:
            out = _attend(q, k, v, self.num_heads)
        elif ctx is not None and ctx.n_data > 1:
            out = _cross_batch_sharded(q, k, v, g, self.num_heads, ctx)
        elif g is None:
            # the layer sees (L=B, N=S, E): per token, attend over the batch
            out = _attend(*(t.transpose(0, 1) for t in (q, k, v)),
                          self.num_heads).transpose(0, 1)
        else:
            b = q.shape[0]
            g = min(g, b)
            if b % g:
                raise ValueError(
                    f"batch {b} not a multiple of attention group {g}")
            out = _grouped(q, k, v, g, self.num_heads)
        return self.out_proj(out)
