"""Device mesh and placement helpers.

Counterpart of ``multipitch_architectures_tpu/parallel/mesh.py``. A
:class:`Mesh` is a ``("data", "model")`` grid of ``torch.device``s;
:func:`batch_sharding` and :func:`replicated` are the placements of
``NamedSharding(mesh, P("data"))`` and ``P()``; the tensor-parallel rules
are the JAX package's ``_TP_RULES`` in the port's names and layouts.
"""

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# JAX (module, leaf) -> PartitionSpec, in the port's names and torch's
# (out, in) layout, as the dim of the parameter split over the model
# axis. flax ``mlp1`` / ``mlp2`` are ``mlp.0`` / ``mlp.2``: ``mlp1``'s
# kernel (in, out) P(None, "model") is ``mlp.0.weight``'s dim 0 and
# ``mlp2``'s P("model", None) ``mlp.2.weight``'s dim 1; the attention
# keeps torch's layout in both packages (in_proj rows sharded, out_proj's
# contraction dim). ``mlp.2``'s and ``out_proj``'s biases stay whole:
# they are added once, after the partial sums are reduced.
_TP_RULES = (
    (re.compile(r"(^|\.)mlp\.0\.weight$"), 0),
    (re.compile(r"(^|\.)mlp\.0\.bias$"), 0),
    (re.compile(r"(^|\.)mlp\.2\.weight$"), 1),
    (re.compile(r"(^|\.)attn\.in_proj_weight$"), 0),   # (3E, E) rows
    (re.compile(r"(^|\.)attn\.in_proj_bias$"), 0),
    (re.compile(r"(^|\.)attn\.out_proj\.weight$"), 1),  # contraction dim
)
# q; k; v packed along dim 0: each of the three is split by heads
_PACKED = re.compile(r"(^|\.)attn\.in_proj_(weight|bias)$")


class Mesh:
    """A 2-D grid of devices with axes ``("data", "model")``: the batch
    splits along ``data``, the tensor-parallel parameters along
    ``model``. ``devices`` is an object array of ``torch.device``; a
    device may appear more than once (logical shards on one device)."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid of devices, "
                             f"not {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The first device: where the canonical model, its optimizer
        and the gathered results live."""
        return self.devices[0, 0]

    def cells(self, model_axis: bool = True) -> List[tuple]:
        """The ``(data, model)`` cells in ``devices.flat`` order; only the
        first of each data row without ``model_axis``."""
        n_data, n_model = self.devices.shape
        return [(d, m) for d in range(n_data)
                for m in range(n_model if model_axis else 1)]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``("data", "model")`` mesh over the first ``n_devices`` of
    ``devices``, by default every visible CUDA device.

    ``model_axis=1`` gives pure data parallelism; a larger value carves
    a tensor-parallel axis out of the device count (it must divide it).
    Without ``devices`` it raises when there is no card or fewer cards
    than ``n_devices``: it never falls back to the CPU and never repeats
    a device; repeating one (``[torch.device("cuda", 0)] * 4``, or
    ``["cpu"] * 8``) is the caller's choice, which gives logical shards.
    """
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_cards == 0:
            raise RuntimeError("make_mesh() spans the visible cards and there "
                               "is none: pass devices= to build a mesh of "
                               "other devices")
        devs = [torch.device("cuda", i) for i in range(n_cards)]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devs):
            raise ValueError(f"n_devices={n_devices} of {len(devs)} "
                             f"devices")
        devs = devs[:n_devices]
    if model_axis < 1 or len(devs) % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide "
                         f"{len(devs)} devices")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(len(devs) // model_axis, model_axis))


def default_mesh() -> Optional[Mesh]:
    """The device set that training spans when the caller names none, as
    the JAX package's ``Trainer`` spans ``jax.devices()``: every visible
    card on the ``data`` axis when there are several; None for one card
    or none (the one-device step, which is what a one-device mesh
    computes, without its shard thread)."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return make_mesh() if n_cards > 1 else None


class ShardedTensor:
    """A global tensor laid out on a mesh: ``shards`` holds one tensor
    per cell, in ``mesh.devices.flat`` order, each on its cell's device
    (the counterpart of a ``jax.Array``'s addressable shards)."""

    def __init__(self, placement: "Placement", shards: List[torch.Tensor],
                 shape: torch.Size):
        self.placement, self.shards, self.shape = placement, shards, shape

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default)."""
        device = self.mesh.device if device is None else device
        if self.placement.axis is None:
            return self.shards[0].to(device)
        n_model = self.mesh.shape["model"]
        return torch.cat([s.to(device) for s in self.shards[::n_model]])


class Placement:
    """Where a tensor goes on a mesh: split along dim 0 over the
    ``data`` axis (:func:`batch_sharding`) or whole on every device
    (:func:`replicated`); the counterpart of ``NamedSharding`` with
    ``P("data")`` or ``P()``."""

    def __init__(self, mesh: Mesh, axis: Optional[str]):
        self.mesh, self.axis = mesh, axis

    def shard_shape(self, shape) -> torch.Size:
        shape = torch.Size(shape)
        if self.axis is None:
            return shape
        n = self.mesh.shape[self.axis]
        if shape[0] % n:
            raise ValueError(f"{shape[0]} rows do not split over {n} "
                             f"{self.axis} shards")
        return torch.Size((shape[0] // n,) + tuple(shape[1:]))

    def place(self, x: torch.Tensor) -> ShardedTensor:
        """``x`` on the mesh (differentiable: copies and slices)."""
        rows = self.shard_shape(x.shape)[0]
        shards = []
        for (d, m), dev in zip(self.mesh.cells(), self.mesh.devices.flat):
            part = x if self.axis is None else x[d * rows:(d + 1) * rows]
            shards.append(part.to(dev))
        return ShardedTensor(self, shards, x.shape)


def batch_sharding(mesh: Mesh) -> Placement:
    return Placement(mesh, "data")


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def tensor_parallel_param_specs(model) -> Dict[str, Optional[int]]:
    """{parameter name: the dim split over the model axis, or None} for
    ``model``'s parameters: the JAX package's rules for the transformer
    layers' attention projections and MLPs (Megatron-style: ``in_proj``
    and ``mlp.0`` split by output rows, ``out_proj`` and ``mlp.2`` by
    their contraction dim), replicated otherwise."""
    specs = {}
    for name, _ in model.named_parameters():
        specs[name] = next((dim for pattern, dim in _TP_RULES
                            if pattern.search(name)), None)
    return specs


def _model_parts(name: str, p: torch.Tensor, dim: int, m: int,
                 n_model: int) -> List[torch.Tensor]:
    """The views of parameter ``p`` that make model shard ``m`` of
    ``n_model`` along ``dim``, concatenated along ``dim``: one, or for the
    packed q; k; v rows of ``in_proj`` three, each of the three split by
    heads (shard ``m`` keeps the same heads of q, k and v)."""
    parts = p.chunk(3) if _PACKED.search(name) else (p,)
    out = []
    for part in parts:
        size = part.shape[dim]
        if size % n_model:
            raise ValueError(f"{name}: {size} along dim {dim} does not split "
                             f"over {n_model} model shards")
        step = size // n_model
        out.append(part.narrow(dim, m * step, step))
    return out


def shard_params(model, mesh: Mesh) -> Dict[str, List[torch.Tensor]]:
    """Place ``model``'s parameters on the mesh by the tensor-parallel
    policy: {name: one tensor per cell, in ``mesh.devices.flat`` order},
    the cell's slice along the model axis where
    :func:`tensor_parallel_param_specs` names a dim, the whole tensor
    otherwise. The placed tensors are copies and slices of the
    parameters: gradients flow back into them through autograd (or
    explicitly, ``spmd.reduce_grads``)."""
    specs = tensor_parallel_param_specs(model)
    n_model = mesh.shape["model"]
    placed = {}
    for name, p in model.named_parameters():
        dim = specs[name] if n_model > 1 else None
        shards = []
        for (_, m), dev in zip(mesh.cells(), mesh.devices.flat):
            if dim is not None:
                parts = _model_parts(name, p, dim, m, n_model)
                shards.append(torch.cat(parts, dim).to(dev)
                              if len(parts) > 1 else parts[0].to(dev))
            else:
                shards.append(p.to(dev))
        placed[name] = shards
    return placed
