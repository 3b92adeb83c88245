"""One model over a mesh: per-cell replicas and the sharded forward.

A replica is a shallow copy of the model's module tree (as
``torch.nn.parallel.replicate`` makes) whose parameters are the cell's
placed tensors (:func:`~.mesh.shard_params`: copies or tensor-parallel
slices of the model's own, so gradients flow back into them) and whose
batch-coupled and random layers keep the global batch's semantics, as
GSPMD's sharded program keeps them in the JAX package:

- train-mode BatchNorm normalises by the statistics of the global batch
  (:class:`GlobalBatchNorm2d`), not of the shard;
- dropout draws the global batch's mask once (:func:`~.collectives.
  dropout`), and a padded batch its real rows' only, each padded row
  taking its source row's;
- cross-batch attention gathers keys and values over the data shards
  where its groups straddle them (``ops.attention``);
- under tensor parallelism, the row-parallel linears (``out_proj``,
  ``mlp.2``) reduce their partial sums over the model axis before their
  bias (:class:`RowParallelLinear`), and the attention runs its shard's
  heads.
"""

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import all_reduce, current, dropout, run_shards
from .mesh import (Mesh, _model_parts, shard_params,
                   tensor_parallel_param_specs)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """A replica's ``nn.BatchNorm2d``. In train mode the batch mean and
    (biased) variance come from the global per-channel sum, centred sum
    of squares and count over the data shards (two reductions; the count
    includes padded rows, as XLA's does); the model's running statistics
    (``_master``) advance once per forward, by the first cell, with
    torch's unbiased variance over the global count. In eval mode it is
    ``nn.BatchNorm2d``."""

    def forward(self, x):
        if not self.training and self.running_mean is not None:
            return super().forward(x)
        ctx = current()
        n = x.numel() // x.shape[1] * ctx.n_data
        if n <= 1:
            raise ValueError(f"BatchNorm in train mode needs more than one "
                             f"value per channel, got {n}")
        dims = (0, 2, 3)
        mean = all_reduce(x.sum(dims), "data") / n
        centred = x - mean[:, None, None]
        var = all_reduce((centred * centred).sum(dims), "data") / n
        y = centred * torch.rsqrt(var + self.eps)[:, None, None]
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        if self.track_running_stats and ctx.index == 0:
            self._advance(mean.detach(), var.detach(), n)
        return y

    def _advance(self, mean, var, n):
        m = self._master
        with torch.no_grad():
            m.num_batches_tracked.add_(1)
            f = m.momentum if m.momentum is not None \
                else 1.0 / float(m.num_batches_tracked)
            rm, rv = m.running_mean, m.running_var
            rm.mul_(1 - f).add_(mean.to(rm), alpha=f)
            rv.mul_(1 - f).add_((var * (n / (n - 1))).to(rv), alpha=f)


class GlobalDropout(nn.Dropout):
    """A replica's ``nn.Dropout``: the global batch's mask (the unpadded
    batch's, on a padded batch)."""

    def forward(self, x):
        return dropout(x, self.p) if self.training else x


class RowParallelLinear(nn.Linear):
    """A replica's linear whose weight is split along its input dim: the
    partial products summed over the model axis, then the bias."""

    def forward(self, x):
        y = all_reduce(F.linear(x, self.weight), "model")
        return y if self.bias is None else y + self.bias


def _swap_class(name, m, r, specs, n_model):
    """Give replica ``r`` of module ``m`` its sharded behaviour."""
    kind = type(m)
    if kind is nn.BatchNorm2d:
        r.__class__ = GlobalBatchNorm2d
        r.__dict__["_master"] = m
    elif kind is nn.Dropout:
        r.__class__ = GlobalDropout
    elif isinstance(m, nn.modules.batchnorm._BatchNorm) or \
            isinstance(m, nn.modules.dropout._DropoutNd) or \
            (isinstance(m, nn.RNNBase) and m.training and m.dropout):
        raise NotImplementedError(f"{name}: {kind.__name__} has no sharded "
                                  f"form")
    if n_model > 1:
        if kind is nn.Linear and specs.get(f"{name}.weight") == 1:
            r.__class__ = RowParallelLinear
        elif specs.get(f"{name}.in_proj_weight") == 0:
            if m.num_heads % n_model:
                raise ValueError(f"{name}: {m.num_heads} heads do not split "
                                 f"over {n_model} model shards")
            r.num_heads = m.num_heads // n_model


def _replica(model: nn.Module, params: dict, device, specs, n_model):
    """One cell's copy of ``model``: new module objects, ``params``
    ({parameter name: tensor}) in place of the parameters, the buffers
    on ``device``."""
    copies = {}
    names = {id(m): name for name, m in model.named_modules()}

    def copy(m):
        if id(m) in copies:
            return copies[id(m)]
        r = m._replicate_for_data_parallel()
        copies[id(m)] = r
        for key, child in m._modules.items():
            r._modules[key] = None if child is None else copy(child)
        for key, buf in m._buffers.items():
            r._buffers[key] = None if buf is None else buf.to(device)
        r._parameters.update((key, None) for key, p in
                             m._parameters.items() if p is None)
        _swap_class(names[id(m)], m, r, specs, n_model)
        return r

    root = copy(model)
    by_id = {id(p): params[name] for name, p in model.named_parameters()}
    for name, p in model.named_parameters(remove_duplicate=False):
        owner, _, leaf = name.rpartition(".")
        setattr(root.get_submodule(owner), leaf, by_id[id(p)])
    return root


def replicate(model: nn.Module, mesh: Mesh, tensor_parallel: bool = True,
              params: Optional[Dict[str, List[torch.Tensor]]] = None
              ) -> List[nn.Module]:
    """One replica of ``model`` per cell that runs: every cell with
    ``tensor_parallel`` (the parameters placed by :func:`shard_params`,
    or ``params``, {name: one tensor per cell} as it gives them), else
    the first cell of each data row (the parameters whole). Build them
    anew after the parameters change place or value by anything but
    in-place updates on their own device."""
    if tensor_parallel:
        cells = mesh.cells()
        placed = params if params is not None else shard_params(model, mesh)
        specs = tensor_parallel_param_specs(model)
        n_model = mesh.shape["model"]
    else:
        cells, specs, n_model = mesh.cells(model_axis=False), {}, 1
        placed = {name: [p.to(mesh.devices[c]) for c in cells]
                  for name, p in model.named_parameters()}
    return [_replica(model, {n: v[i] for n, v in placed.items()},
                     mesh.devices[c], specs, n_model)
            for i, c in enumerate(cells)]


def shard_leaves(model: nn.Module, mesh: Mesh) -> Dict[str, List[torch.Tensor]]:
    """:func:`shard_params` as leaves of their own (sharing storage with
    the parameters where they are slices on the same device): a training
    step's replicas take these, and :func:`reduce_grads` sums their
    gradients into the parameters in a fixed order."""
    with torch.no_grad():
        placed = shard_params(model, mesh)
    return {name: [t.detach().requires_grad_() for t in shards]
            for name, shards in placed.items()}


def reduce_grads(model: nn.Module, mesh: Mesh,
                 leaves: Dict[str, List[torch.Tensor]]):
    """Each parameter's gradient from its cells' leaves: the data
    shards' gradients summed (the data-parallel all-reduce) and the
    model shards' written to their slices (the tensor-parallel gather),
    on the parameter's device, in cell order, so that the sum is the
    same in every run; added to ``.grad``."""
    specs = tensor_parallel_param_specs(model)
    n_model = mesh.shape["model"]
    for name, p in model.named_parameters():
        total = torch.zeros_like(p)
        dim = specs[name] if n_model > 1 else None
        for (_, m), leaf in zip(mesh.cells(), leaves[name]):
            if leaf.grad is None:
                continue
            g = leaf.grad.to(p.device)
            if dim is None:
                total += g
                continue
            views = _model_parts(name, total, dim, m, n_model)
            for view, piece in zip(views, g.split(
                    [v.shape[dim] for v in views], dim)):
                view += piece
        p.grad = total if p.grad is None else p.grad + total


def apply_sharded(replicas: List[nn.Module], mesh: Mesh,
                  inputs: list, rows: Optional[int] = None) -> list:
    """``replicas[i](inputs[i])`` for the cells of :func:`replicate` (all
    of the mesh's, or one per data row), each in its shard's thread
    (:func:`~.collectives.run_shards`), with the card of the cell
    current. ``rows``: the global batch's real samples when the inputs
    are those padded by wrap-around (dropout then draws the unpadded
    batch's masks). Returns the outputs in cell order."""
    cells = mesh.cells(model_axis=len(replicas) == mesh.size)

    def run(i):
        dev = mesh.devices[cells[i]]
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return replicas[i](inputs[i])
        return replicas[i](inputs[i])

    padded = inputs[0].shape[0] * mesh.shape["data"]
    batch = None if rows is None or rows == padded else (rows, padded)
    return run_shards(mesh, cells, run, batch)


def gather_rows(outputs: list, mesh: Mesh, device):
    """The data rows' outputs (of the first cell of each) concatenated
    along dim 0 on ``device``; tuples element by element."""
    rows = outputs[::len(outputs) // mesh.shape["data"]]
    if isinstance(rows[0], tuple):
        return tuple(torch.cat([r[k].to(device) for r in rows])
                     for k in range(len(rows[0])))
    return torch.cat([r.to(device) for r in rows])
