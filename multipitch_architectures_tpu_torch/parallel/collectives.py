"""Collectives across the shards of a mesh, driven by one process.

The JAX package leaves its collectives to XLA (GSPMD inserts them). Here
one process drives every shard: :func:`run_shards` runs each shard's
work in a thread of its own, with a thread-local :class:`ShardContext`.
A collective is a meeting point of all shards: each hands in its tensor,
and the first shard's thread, once all have arrived, computes the result
for all of them and hands each its part. The result is one autograd node
over every shard's tensor (:class:`_AllReduce`, :class:`_AllGather`), so
the backward pass, which the autograd engine runs over one graph, needs
no meeting of its own. Computing it always in the same thread keeps the
graph, and so the order of its gradient sums, the same in every run.
The copies between devices are ``Tensor.to``; a mesh may name one device
several times, and the arithmetic is then the same as on distinct ones.

Every shard must call the same collectives in the same order (they all
run the same program on equal shapes); a shard that ends while others
wait at a collective fails the call.
"""

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_local = threading.local()


class _Rendezvous:
    """The meeting points of one sharded call: the k-th collective of
    every shard meets the k-th of the others."""

    def __init__(self, n: int):
        self.n = n
        self._cond = threading.Condition()
        self._slots = {}
        self._error: Optional[BaseException] = None
        self._finished = 0

    def _check(self):
        if self._error is not None:
            raise RuntimeError("another shard failed") from self._error
        if self._finished:
            raise RuntimeError("a shard ended before this collective: the "
                               "shards ran different programs")

    def exchange(self, call: int, index: int, value, fn: Callable):
        """Hand in ``value`` as shard ``index``'s part of collective
        ``call``; shard 0 computes ``fn(values)`` (a list with one result
        per shard) for all once every shard has arrived. Returns this
        shard's result."""
        with self._cond:
            self._check()
            slot = self._slots.setdefault(call, {"values": [None] * self.n,
                                                 "arrived": 0, "out": None,
                                                 "taken": 0})
            slot["values"][index] = value
            slot["arrived"] += 1
            self._cond.notify_all()
            if index == 0:
                while slot["arrived"] < self.n:
                    self._check()
                    self._cond.wait()
                try:
                    slot["out"] = fn(slot["values"])
                except BaseException as e:
                    self._error = e
                    self._cond.notify_all()
                    raise
                slot["values"] = None
                self._cond.notify_all()
            while slot["out"] is None:
                self._check()
                self._cond.wait()
            out = slot["out"][index]
            slot["taken"] += 1
            if slot["taken"] == self.n:
                del self._slots[call]
            return out

    def fail(self, error: BaseException):
        with self._cond:
            if self._error is None:
                self._error = error
            self._cond.notify_all()

    def finish(self):
        with self._cond:
            self._finished += 1
            self._cond.notify_all()


class ShardContext:
    """What a shard's thread knows of its call: the mesh, the cells
    ``(data, model)`` that run, its own index among them, the call's
    meeting points, and ``batch``: None, or ``(real, padded)`` when the
    global batch of ``padded`` samples is ``real`` samples padded by
    wrap-around (sample ``real + j`` repeats sample ``j mod real``)."""

    def __init__(self, mesh, cells: Sequence, index: int,
                 rendezvous: _Rendezvous,
                 batch: Optional[Tuple[int, int]] = None):
        self.mesh, self.cells, self.index = mesh, list(cells), index
        self.batch = batch
        self.data, self.model = self.cells[index]
        self.device = mesh.devices[self.data, self.model]
        self._rendezvous = rendezvous
        self._calls = 0

    @property
    def n_data(self) -> int:
        return int(self.mesh.shape["data"])

    def groups(self, axis: str) -> List[List[int]]:
        """The cells that reduce together along ``axis``: those equal in
        the other coordinate, each group in ``axis`` order."""
        k = {"data": 1, "model": 0}[axis]
        groups = {}
        for i, cell in enumerate(self.cells):
            groups.setdefault(cell[k], []).append(i)
        return [sorted(g, key=lambda i: self.cells[i][1 - k])
                for g in groups.values()]

    def exchange(self, value, fn: Callable):
        call, self._calls = self._calls, self._calls + 1
        return self._rendezvous.exchange(call, self.index, value, fn)


def current() -> Optional[ShardContext]:
    """The calling thread's shard context; None outside a sharded call."""
    return getattr(_local, "context", None)


def run_shards(mesh, cells: Sequence, fn: Callable[[int], object],
               batch: Optional[Tuple[int, int]] = None) -> list:
    """``fn(i)`` for each cell ``i`` of ``cells`` (``(data, model)``
    pairs of ``mesh``), each in a thread of its own with its
    :class:`ShardContext` (inline for a single cell; ``batch`` as it
    says), under the caller's grad mode. Returns the results in cell
    order; raises the first shard's error."""
    cells = list(cells)
    rendezvous = _Rendezvous(len(cells))
    grad = torch.is_grad_enabled()
    results, errors = [None] * len(cells), []

    def work(i):
        torch.set_grad_enabled(grad)
        _local.context = ShardContext(mesh, cells, i, rendezvous, batch)
        try:
            results[i] = fn(i)
        except BaseException as e:
            errors.append(e)
            rendezvous.fail(e)
        finally:
            _local.context = None
            rendezvous.finish()

    if len(cells) == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(len(cells))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        # a shard's own error, not the "another shard failed" it caused
        own = [e for e in errors if not (isinstance(e, RuntimeError) and
                                         e.__cause__ is not None)]
        raise (own or errors)[0]
    return results


def _sum_on(tensors, device):
    total = tensors[0].to(device)
    for t in tensors[1:]:
        total = total + t.to(device)
    return total


class _AllReduce(torch.autograd.Function):
    """The sum of a group's tensors (added in group order on the first
    member's device), one copy on each member's device; the backward
    pass is the same reduction of the outputs' gradients."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        total = _sum_on(xs, xs[0].device)
        return tuple(total.to(d, copy=True) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = _sum_on(grads, ctx.devices[0])
        return tuple(total.to(d, copy=True) for d in ctx.devices)


class _AllGather(torch.autograd.Function):
    """A group's tensors concatenated along dim 0 in group order, one
    copy on each member's device; the backward pass sums the outputs'
    gradients and hands each member its rows."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        ctx.rows = [x.shape[0] for x in xs]
        whole = torch.cat([x.to(xs[0].device) for x in xs])
        return tuple(whole.to(d, copy=True) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = _sum_on(grads, ctx.devices[0])
        return tuple(part.to(d, copy=True) for part, d in
                     zip(total.split(ctx.rows), ctx.devices))


def _collective(function, x, axis):
    ctx = current()
    groups = ctx.groups(axis)
    if all(len(g) == 1 for g in groups):
        return x

    def compute(values):
        out = [None] * len(values)
        for g in groups:
            for i, y in zip(g, function.apply(*(values[i] for i in g))):
                out[i] = y
        return out

    return ctx.exchange(x, compute)


def all_reduce(x, axis: str):
    """Inside a sharded call: the sum of ``x`` over the shards of
    ``axis`` (``"data"`` or ``"model"``), on this shard's device."""
    return _collective(_AllReduce, x, axis)


def all_gather(x, axis: str):
    """Inside a sharded call: ``x`` of every shard of ``axis``
    concatenated along dim 0 in shard order, on this shard's device."""
    return _collective(_AllGather, x, axis)


def _ones_laid_out_like(x, rows, device):
    """Ones of ``x``'s shape with ``rows`` rows, its dims in memory in
    ``x``'s order (dropout draws its mask in memory order)."""
    order = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
    shape = (rows,) + tuple(x.shape[1:])
    ones = torch.ones([shape[d] for d in order], dtype=x.dtype, device=device)
    return ones.permute([order.index(d) for d in range(x.dim())])


def dropout(x, p: float):
    """Inside a sharded call: ``F.dropout(x, p, training=True)`` with the
    mask of the global batch (``x``'s rows on every data shard, in order),
    drawn once on the first cell's device by ``F.dropout`` of ones laid
    out as ``x`` and sliced, so that every layout of one global batch,
    one device included, draws the same mask from the same generator
    state. A batch padded by wrap-around (``ShardContext.batch``) draws
    the mask of its real rows only, which is what the unpadded batch
    draws, and each padded row takes its source row's: every later draw
    then consumes the generator as the unpadded step does, and a padded
    row stays a copy of its source row. ``x`` holds the same number of
    rows per sample (a layer may fold other dims into the batch's),
    sample-major."""
    if p == 0.0:
        return x
    ctx = current()

    def draw(values):
        rows = values[0].shape[0]
        total = rows * ctx.n_data
        first = ctx.mesh.devices[ctx.cells[0]]
        real = total
        if ctx.batch is not None:
            n, padded = ctx.batch
            real = total // padded * n
        mask = F.dropout(_ones_laid_out_like(values[0], real, first), p, True)
        if real < total:
            mask = mask[torch.arange(total, device=first) % real]
        return [mask[d * rows:(d + 1) * rows].to(ctx.mesh.devices[d, m])
                for d, m in ctx.cells]

    return x * ctx.exchange(x.detach(), draw)
