"""Every class of the port's model zoo on a device mesh, on the CPU.

One tiny configuration of each of the 26 classes, from the cases of
tests/test_torch_zoo.py, test_torch_zoo_unets.py, test_torch_zoo_freq.py
and test_torch_zoo_cnns.py (and the SAUnet, which they leave to
tests/test_torch_models.py), takes one training step (forward in train
mode, a squared-error loss on every output, backward) in float64,
dropout 0, on a batch of 4, through ``parallel.spmd`` replicas on four
logical CPU shards: ``data=4`` and ``data=2 x model=2`` (tensor
parallelism of the attention and MLPs). It must be the one-device step
on the same rows: the loss to 1e-12 relative, every gradient to 1e-12 of
the largest gradient norm. Only the order of the sums differs between
the layouts.

This file holds the CNNs, DRCNN, SimpleUNet and the six-layer
self-attention U-Net, and the shared check; the other classes are in
tests/test_torch_parallel_zoo_*.py, one to six a file (``HELD``): a step
of the tiny U-Nets (15 x 15 float64 convolutions on 75 x 216 maps) takes
seconds on the CPU, so one configuration per class, not every
configuration of the zoo tests, at batch 4, keeps each file under a
minute and the suite within its time.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch
from torch import nn

from test_torch_zoo import CASES as ZOO
from test_torch_zoo_cnns import CASES as CNNS
from test_torch_zoo_freq import CASES as FREQ
from test_torch_zoo_unets import CASES as UNETS

from multipitch_architectures_tpu_torch.experiments import MODEL_REGISTRY
from multipitch_architectures_tpu_torch.models import (
    SimpleUNetDoubleSelfAttn, init_parameters)
from multipitch_architectures_tpu_torch.parallel import (
    apply_sharded, batch_sharding, gather_rows, make_mesh, reduce_grads,
    replicate, shard_leaves)

# name -> (port class, kwargs): every configuration of the zoo tests
CASES = {f"{table}:{name}": (case[1], case[2])
         for table, cases in (("zoo", ZOO), ("unets", UNETS),
                              ("freq", FREQ), ("cnns", CNNS))
         for name, case in cases.items()}
CASES["saunet"] = (SimpleUNetDoubleSelfAttn, ZOO["sausnet"][2])
# the configuration of each class that is held on the meshes, by file
HELD = {
    "test_torch_parallel_zoo": (
        "cnns:basic_cnn", "cnns:basic_cnn_pool", "cnns:segm_logsoftmax",
        "cnns:segm_blank_logsoftmax", "zoo:cnn", "zoo:drcnn",
        "unets:simple_u_net", "unets:sixselfattn_learnable"),
    "test_torch_parallel_zoo_freq": (
        "freq:freq_u_net", "freq:freq_bottomstack", "freq:freq_selfattn",
        "freq:freq_doubleselfattn", "zoo:unet", "zoo:blunet_depth1"),
    "test_torch_parallel_zoo_temporal": ("freq:temporal_selfattn",),
    "test_torch_parallel_zoo_blstm": ("freq:temporal_blstm",),
    "test_torch_parallel_zoo_selfattn": ("saunet", "unets:selfattn"),
    "test_torch_parallel_zoo_varlayers": ("unets:varlayers_depth2_one_sin",
                                          "zoo:sausnet"),
    "test_torch_parallel_zoo_transenc": ("unets:transenc",),
    "test_torch_parallel_zoo_alllayers": ("unets:alllayers", "zoo:punet"),
    "test_torch_parallel_zoo_polyphony": (
        "unets:polyphony", "unets:polyphony_classif",
        "unets:polyphony_plain"),
}
BATCH = 4             # one sample per shard on data=4, two on data=2
LOSS_RTOL = 1e-12
GRAD_TOL = 1e-12      # of the largest gradient norm
MESHES = {"data=4": 1, "data=2 x model=2": 2}
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3      # glibc's mallopt


@contextlib.contextmanager
def step_settings(threads):
    """``threads`` torch threads, and glibc's heap (not a fresh mapping)
    for large buffers: each float64 convolution's unfolded input (tens
    of MB) would otherwise be mapped and page-faulted anew on every
    call, about half of these steps' time. Both restored after, the
    heap's free memory returned."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    libc = ctypes.CDLL(None)
    glibc = hasattr(libc, "mallopt") and hasattr(libc, "malloc_trim")
    if glibc:
        libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(_M_TRIM_THRESHOLD, 1 << 31)
    try:
        yield
    finally:
        torch.set_num_threads(before)
        if glibc:
            # glibc's own ceiling for its adaptive thresholds
            libc.mallopt(_M_MMAP_THRESHOLD, 32 << 20)
            libc.mallopt(_M_TRIM_THRESHOLD, 64 << 20)
            libc.malloc_trim(0)


@pytest.fixture(autouse=True, scope="module")
def _settings():
    with step_settings(1):
        yield


def _step(model, x, targets, mesh=None):
    """(loss, {name: gradient}) of one training step of ``model`` on
    ``x``: the mean squared error of each output against its target,
    summed, on one device or sharded over ``mesh`` (the gradients summed
    as the trainer sums them). ``targets`` maps the outputs' shapes to
    the targets."""
    model.zero_grad(set_to_none=True)
    if mesh is None:
        out = model(x)
    else:
        leaves = shard_leaves(model, mesh)
        replicas = replicate(model, mesh, params=leaves)
        out = gather_rows(apply_sharded(
            replicas, mesh, batch_sharding(mesh).place(x).shards), mesh,
            x.device)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum(((o - t) ** 2).mean()
               for o, t in zip(outs, targets([o.shape for o in outs])))
    loss.backward()
    if mesh is not None:
        reduce_grads(model, mesh, leaves)
    return float(loss.detach()), {k: p.grad.clone() for k, p in
                                  model.named_parameters()
                                  if p.grad is not None}


def test_one_configuration_of_every_class_is_held():
    """The files hold each of the 26 classes once."""
    held = [name for names in HELD.values() for name in names]
    assert len(held) == len(set(held)) == 26
    assert {CASES[n][0] for n in held} == {CASES[n][0] for n in CASES}
    assert {CASES[n][0] for n in held} == set(MODEL_REGISTRY.values())


def check_on_meshes(name):
    """One float64 step of ``CASES[name]`` on each of ``MESHES`` against
    the one-device step (module docstring)."""
    cls, kwargs = CASES[name]
    model = cls(**kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    model.double().train()
    rng = np.random.RandomState(sorted(CASES).index(name))
    x = torch.from_numpy(np.log1p(10 * rng.rand(BATCH, 6, 75, 216)))
    made = []

    def targets(shapes):
        if not made:
            made.extend(torch.from_numpy(rng.rand(*s)) for s in shapes)
        return made

    state = {k: v.clone() for k, v in model.state_dict().items()}
    loss0, grads0 = _step(model, x, targets)
    scale = max(float(g.norm()) for g in grads0.values())
    assert scale > 0
    for mesh_name, model_axis in MESHES.items():
        model.load_state_dict(state)
        mesh = make_mesh(devices=["cpu"] * 4, model_axis=model_axis)
        loss, grads = _step(model, x, targets, mesh)
        assert abs(loss - loss0) <= LOSS_RTOL * abs(loss0), (mesh_name, loss,
                                                            loss0)
        assert grads.keys() == grads0.keys()
        worst = max(float((grads[k] - g).abs().max())
                    for k, g in grads0.items())
        assert worst <= GRAD_TOL * scale, (mesh_name, worst, scale)


@pytest.mark.parametrize("name", HELD["test_torch_parallel_zoo"])
def test_zoo_step_on_a_mesh_is_the_one_device_step(name):
    check_on_meshes(name)
