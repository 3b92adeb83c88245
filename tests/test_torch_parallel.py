"""The port's parallelism against the JAX package's, on the CPU.

The JAX side runs on the conftest's 8-device virtual CPU mesh (the
padded float64 step in a process of its own, ``_jax_train_steps.py
--mesh8``); the port's meshes name the CPU eight times (logical shards:
the same arithmetic as eight devices). The cases mirror
``tests/test_parallel.py``: the mesh, ``_shard``'s padding, a loss that
does not depend on the mesh, the padded data-parallel step of the
batch-coupled tiny SAUnet (global BatchNorm statistics and cross-batch
attention) against the JAX package's, tensor parallelism, the sharded
windowed protocol and the runner's sharded test phase; then the
checkpoints and the sharded attention's group layouts.

Tolerances: losses 1e-5 in float32 (1e-6 relative, and BatchNorm
statistics 1e-6, against JAX in float64); windowed predictions 2e-5;
float64 gradients of one layout against another 1e-9 relative L2
(float32 gradients of these models are only good to a few 1e-3: the
normalisations' cancellations).
"""

import dataclasses
import logging
import os
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util
from torch import nn

import _jax_train_steps
from test_torch_zoo import seeded_variables

from multipitch_architectures_tpu import parallel as jparallel
from multipitch_architectures_tpu.eval import (
    predict_framewise_sharded as jax_predict_framewise_sharded)
from multipitch_architectures_tpu.models import (
    BasicCnnSegmSigmoid as JaxBasicCnn,
    SimpleUNetDoubleSelfAttn as JaxSAUnet)
from multipitch_architectures_tpu.train import (TrainConfig as JaxTrainConfig,
                                                Trainer as JaxTrainer)
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.eval import (predict_framewise,
                                                     predict_framewise_sharded)
from multipitch_architectures_tpu_torch.experiments import (
    SyntheticCorpus, load_experiment, run_experiment, shrink_for_smoke)
from multipitch_architectures_tpu_torch.models import (
    BasicCnnSegmSigmoid, DoubleConv, SimpleUNetDoubleSelfAttn,
    TransformerEncLayer, init_parameters, state_dict_from_flax)
from multipitch_architectures_tpu_torch.parallel import (
    apply_sharded, batch_sharding, default_mesh, gather_rows, make_mesh,
    reduce_grads, replicate, shard_leaves, tensor_parallel_param_specs)
from multipitch_architectures_tpu_torch.parallel.collectives import (
    all_reduce, dropout, run_shards)
from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer
from multipitch_architectures_tpu_torch.train.trainer import _Checkpointer

TINY = _jax_train_steps.TINY
CNN = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72)
SAUNET = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=16,
              embed_dim=32, num_heads=8, mlp_dim=64)
# the same geometry at a quarter of the widths, for steps that only
# compare one layout with another (a CPU step of SAUNET takes seconds)
MICRO = dict(n_chan_layers=(2, 2, 2, 1), n_bins_out=72, scalefac=64,
             embed_dim=8, num_heads=4, mlp_dim=16)
STEP = dict(scheduler=None, early_stopping=False)


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n=8, model_axis=1):
    return make_mesh(devices=["cpu"] * n, model_axis=model_axis)


def _batch(n, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(n, 6, 75, 216)).to(dtype),
            torch.from_numpy(rng.rand(n, 1, 1, 72) > 0.9).to(dtype))


def _step(make, batch, mesh=None, dtype=torch.float32, seed=7, w=None):
    """One train step of a fresh ``make()`` (weights seeded 0) on one
    device or on ``mesh``: (loss, {name: gradient}, trainer)."""
    model = make()
    init_parameters(model, torch.Generator().manual_seed(0))
    trainer = Trainer(model.to(dtype), TrainConfig(
        batch_size=batch[0].shape[0], **STEP),
        device=None if mesh else "cpu", mesh=mesh)
    torch.manual_seed(seed)
    loss = float(trainer.train_step(*batch, w))
    return loss, {k: p.grad.clone() for k, p in
                  trainer.model.named_parameters()}, trainer


def _rel_l2(a, b):
    da = torch.cat([(a[k] - b[k]).flatten() for k in b])
    return float(da.norm() / torch.cat([b[k].flatten() for k in b]).norm())


# -- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("n, model_axis, shape", [
    (None, 1, {"data": 8, "model": 1}), (None, 2, {"data": 4, "model": 2}),
    (4, 1, {"data": 4, "model": 1}), (4, 4, {"data": 1, "model": 4})])
def test_make_mesh_shapes(n, model_axis, shape):
    mesh = make_mesh(n, model_axis, devices=["cpu"] * 8)
    assert mesh.shape == shape
    jmesh = jparallel.make_mesh(n, model_axis)
    assert dict(jmesh.shape) == shape
    assert mesh.devices.shape == jmesh.devices.shape


@pytest.mark.parametrize("kw, error", [
    (dict(), RuntimeError),                   # no card: no CPU fallback
    (dict(n_devices=2), RuntimeError),        # nor a repeated device
    (dict(n_devices=9, devices=["cpu"] * 8), ValueError),
    (dict(model_axis=3, devices=["cpu"] * 8), ValueError)])
def test_make_mesh_raises(kw, error):
    with pytest.raises(error):
        make_mesh(**kw)


@pytest.mark.parametrize("n_cards", [0, 1, 2, 4])
def test_default_mesh_spans_the_visible_cards(monkeypatch, n_cards):
    """No mesh for no card or one (the one-device step), else every card
    on the ``data`` axis, as the JAX package's ``Trainer`` spans all
    devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    mesh = default_mesh()
    if n_cards < 2:
        assert mesh is None
    else:
        assert mesh.shape == {"data": n_cards, "model": 1}
        assert list(mesh.devices.flat) == [torch.device("cuda", i)
                                           for i in range(n_cards)]


class _Stays(BasicCnnSegmSigmoid):
    """A model that stays on the CPU wherever it is sent: a trainer on
    cards that this machine lacks can be built."""

    def to(self, *args, **kwargs):
        return self


@pytest.mark.parametrize("n_cards", [1, 2, 4])
def test_trainer_without_a_device_spans_the_cards(monkeypatch, n_cards):
    """``Trainer(model, cfg)`` takes ``default_mesh()``: a ``data=N``
    mesh of N > 1 cards, the one-device step on one card; an explicit
    ``device`` keeps one device whatever the count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    trainer = Trainer(_Stays(**CNN), TrainConfig())
    if n_cards == 1:
        assert trainer.mesh is None
        assert trainer.device == torch.device("cuda")
    else:
        assert trainer.mesh.shape == {"data": n_cards, "model": 1}
        assert trainer.device == torch.device("cuda", 0)
    one = Trainer(BasicCnnSegmSigmoid(**CNN), TrainConfig(), device="cpu")
    assert one.mesh is None and one.device == torch.device("cpu")


def test_trainer_mesh_implies_its_device():
    mesh = cpu_mesh()
    assert Trainer(BasicCnnSegmSigmoid(**CNN), TrainConfig(),
                   mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's first"):
        Trainer(BasicCnnSegmSigmoid(**CNN), TrainConfig(), device="meta",
                mesh=mesh)


def test_shard_rows_and_wraparound_padding_match_jax():
    """Each of 8 shards holds batch/8 rows in order; 5 samples pad to 8
    by repeating the leading ones, with loss weights 0, as JAX's
    ``Trainer._shard``."""
    x, y = _batch(16, seed=3)
    ours = Trainer(BasicCnnSegmSigmoid(**CNN), TrainConfig(batch_size=16),
                   mesh=cpu_mesh())
    theirs = JaxTrainer(JaxBasicCnn(**CNN), JaxTrainConfig(batch_size=16),
                        mesh=jparallel.make_mesh(8))
    xs, _, _ = ours._shard(x, y)
    jxs, _, _ = theirs._shard(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    jshards = sorted(jxs.addressable_shards, key=lambda s: s.index[0].start)
    assert len(xs.shards) == len(jshards) == 8
    for k, (s, js) in enumerate(zip(xs.shards, jshards)):
        assert s.shape == (2, 6, 75, 216)
        np.testing.assert_array_equal(s.numpy(), x[2 * k:2 * k + 2].numpy())
        np.testing.assert_array_equal(s.numpy(), np.asarray(js.data))
    xs5, ys5, ws5 = ours._shard(x[:5], y[:5])
    jx5, _, jw5 = theirs._shard(jnp.asarray(x[:5].numpy()),
                                jnp.asarray(y[:5].numpy()))
    np.testing.assert_array_equal(ws5.gather().numpy(), [1, 1, 1, 1, 1, 0, 0,
                                                         0])
    np.testing.assert_array_equal(ws5.gather().numpy(), np.asarray(jw5))
    np.testing.assert_array_equal(xs5.gather().numpy(), np.asarray(jx5))
    np.testing.assert_array_equal(xs5.gather()[5:].numpy(), x[:3].numpy())


# -- data parallelism ---------------------------------------------------------

def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def test_dp_loss_invariant_to_mesh_size():
    """The same global batch gives the same loss on no mesh, a 1-device
    and an 8-shard data mesh, dropout on: its mask is the global
    batch's."""
    batch = _batch(8)
    make = lambda: BasicCnnSegmSigmoid(**CNN)
    loss0, _, _ = _step(make, batch)
    loss1, _, _ = _step(make, batch, cpu_mesh(1))
    loss8, _, _ = _step(make, batch, cpu_mesh(8))
    assert abs(loss1 - loss0) < 1e-5 and abs(loss8 - loss0) < 1e-5, \
        (loss0, loss1, loss8)


def test_dp_uneven_batch_decoupled_model_is_the_unpadded_loss():
    """5 samples on 8 shards pad to 8 with weight 0; a model without
    batch coupling gives the unpadded batch's loss, dropout on, as in
    the JAX package's tests/test_parallel.py: each dropout draws the 5
    real rows' mask, as the unpadded step does, and the padded rows take
    their source rows' masks."""
    batch = _batch(5, seed=1)
    make = lambda: BasicCnnSegmSigmoid(**CNN)
    loss1, _, _ = _step(make, batch)
    loss8, _, _ = _step(make, batch, cpu_mesh(8))
    assert abs(loss1 - loss8) < 1e-5, (loss1, loss8)


@pytest.fixture(scope="module")
def jax_mesh8_step(tmp_path_factory):
    """The JAX package's padded step (batch 5 on 8 devices, float64), in
    a process of its own: started here, read by ``result()``."""
    path = tmp_path_factory.mktemp("mesh8") / "step.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen([sys.executable, _jax_train_steps.__file__,
                             "--mesh8", str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with np.load(path) as f:
            return dict(f)

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_dp_uneven_batch_coupled_model_matches_jax(jax_mesh8_step):
    """The batch-coupled tiny SAUnet (train-mode BatchNorm, cross-batch
    attention) at batch 5 on 8 shards, float64, dropout off: the padded
    rows enter the global statistics and the attention with zero loss
    weight. Loss, parameters and BatchNorm statistics equal the JAX
    package's step; per-shard statistics or shard-local attention would
    not."""
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                             _jax_train_steps.golden_variables())
    model = _no_dropout(SimpleUNetDoubleSelfAttn(**TINY).double())
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_flax(variables).items()})
    start = {k: v.clone() for k, v in model.state_dict().items()}
    n_shard = {}

    def count(name):
        def hook(module, args):
            n_shard[name] = args[0].numel() // args[0].shape[1]
        return hook

    for name, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):     # the replicas share hooks
            m.register_forward_pre_hook(count(name))
    x, y = (torch.from_numpy(a) for a in _jax_train_steps.mesh_batch())
    trainer = Trainer(model, TrainConfig(
        **_jax_train_steps.MESH_TRAIN_CONFIG), mesh=cpu_mesh(8))
    loss = float(trainer.train_step(x, y))
    saved = jax_mesh8_step()
    assert loss == pytest.approx(float(saved["loss"]), rel=1e-6)
    np.testing.assert_array_equal(trainer._shard(x, y)[2].gather().numpy(),
                                  saved["weights"])
    flat = {k[len("after_step/"):]: v for k, v in saved.items()
            if k.startswith("after_step/")}
    theirs = {k: np.asarray(v) for k, v in state_dict_from_flax(
        traverse_util.unflatten_dict(flat, sep="/")).items()}
    ours = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, want in theirs.items():
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
            np.testing.assert_allclose(ours[k], want, rtol=0, atol=1e-5,
                                       err_msg=k)
    assert n_shard and all(ours[f"{k}.num_batches_tracked"] == 1
                           for k in n_shard)
    for name, per_shard in n_shard.items():
        n = 8 * per_shard                     # the padded count
        np.testing.assert_allclose(ours[f"{name}.running_mean"],
                                   theirs[f"{name}.running_mean"],
                                   rtol=1e-6, atol=1e-8, err_msg=name)
        key = f"{name}.running_var"
        got = (ours[key] - 0.9 * start[key].numpy()) * (n - 1) / n
        want = theirs[key] - 0.9 * start[key].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8,
                                   err_msg=name)


def test_padded_step_is_the_explicitly_padded_one_device_step():
    """The semantics the JAX package computes: the mesh step on 5
    samples equals the one-device step on the 8 padded rows with weight
    0 for the padding: the loss, and the BatchNorm statistics over the
    padded count. Dropout off on both sides: the mesh step draws the
    unpadded batch's masks, which the one-device step on 8 rows does not
    (test_sharded_dropout_of_a_padded_batch_is_the_unpadded_batchs)."""
    x, y = _batch(5, seed=4)
    make = lambda: _no_dropout(SimpleUNetDoubleSelfAttn(**MICRO))
    idx = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2])
    w = torch.tensor([1.0] * 5 + [0.0] * 3)
    loss1, _, t1 = _step(make, (x[idx], y[idx]), w=w)
    loss8, _, t8 = _step(make, (x, y), cpu_mesh(8))
    assert loss8 == pytest.approx(loss1, rel=1e-5)
    s1, s8 = t1.model.state_dict(), t8.model.state_dict()
    for k in s1:
        if "running" in k:
            torch.testing.assert_close(s8[k], s1[k], rtol=1e-5, atol=1e-6)


def _layer_on(layer, x, r, mesh=None):
    """Output, input gradient and parameter gradients of ``layer`` on
    ``x`` against the cotangent ``r``, dropout seeded, on one device or
    sharded over ``mesh`` (the gradients summed as the trainer sums
    them)."""
    x = x.clone().requires_grad_()
    layer.zero_grad()
    torch.manual_seed(11)
    if mesh is None:
        out = layer(x)
    else:
        leaves = shard_leaves(layer, mesh)
        replicas = replicate(layer, mesh, params=leaves)
        out = gather_rows(apply_sharded(
            replicas, mesh, batch_sharding(mesh).place(x).shards), mesh,
            x.device)
    (out * r).sum().backward()
    if mesh is not None:
        reduce_grads(layer, mesh, leaves)
    return out.detach(), x.grad, {k: p.grad.clone() for k, p in
                                  layer.named_parameters()}


@pytest.mark.parametrize("mode, batch, n_data, n_model", [
    ("cross_batch", 8, 8, 1),        # the whole batch, gathered
    ("cross_batch:4", 8, 8, 1),      # groups straddle the shards
    ("cross_batch:4", 8, 2, 1),      # groups whole on a shard: local
    ("cross_batch:4", 12, 2, 1),     # a shard spans two groups: masked
    ("cross_batch:16", 8, 4, 1),     # the group is the whole batch
    ("cross_batch", 8, 4, 2),        # heads and MLP split over 2
    ("cross_batch:2", 4, 2, 4),      # two heads per model shard
    ("tokens", 4, 2, 2),
])
def test_sharded_transformer_layer_is_the_global_batchs(mode, batch, n_data,
                                                        n_model):
    """A transformer layer (dropout 0.2 on) sharded over a (data, model)
    mesh gives one device's outputs and gradients, float64, for each way
    the attention groups lie on the data shards, and with the heads and
    the MLP split over the model axis."""
    layer = TransformerEncLayer(32, 8, 64, pos_encoding="sinusoidal",
                                attn_mode=mode)
    init_parameters(layer, torch.Generator().manual_seed(0))
    layer.double().train()
    rng = np.random.RandomState(batch + n_data)
    x = torch.from_numpy(rng.randn(batch, 32, 2, 3))
    r = torch.from_numpy(rng.randn(batch, 32, 2, 3))
    want = _layer_on(layer, x, r)
    got = _layer_on(layer, x, r, cpu_mesh(n_data * n_model, n_model))
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    assert _rel_l2(got[2], want[2]) < 1e-10


def test_sharded_batchnorm_is_the_global_batchs():
    """Train-mode BatchNorm over 3 data shards: the global batch's
    normalisation and gradients, and the running statistics advanced
    once, with torch's unbiased variance over the global count."""
    block = DoubleConv(3, 4).double().train()
    init_parameters(block, torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in block.state_dict().items()}
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(6, 3, 5, 7))
    r = torch.from_numpy(rng.randn(6, 4, 5, 7))
    want = _layer_on(block, x, r)
    after = {k: v.clone() for k, v in block.state_dict().items()}
    block.load_state_dict(before)
    got = _layer_on(block, x, r, cpu_mesh(3))
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    assert _rel_l2(got[2], want[2]) < 1e-10
    for k, v in block.state_dict().items():
        torch.testing.assert_close(v, after[k], rtol=1e-10, atol=1e-12)


def test_val_in_train_mode_ragged_batch_runs_unpadded():
    """On a mesh, a validation batch that does not fill it runs
    unpadded on the first device when ``val_in_train_mode`` keeps the
    BatchNorm statistics (the JAX package places it replicated): one
    device's loss and statistics; a full one runs sharded, equal within
    float32."""
    for n in (5, 8):
        x, y = _batch(n, seed=6)
        out = []
        for mesh in (None, cpu_mesh(8)):
            model = SimpleUNetDoubleSelfAttn(**MICRO)
            init_parameters(model, torch.Generator().manual_seed(0))
            tr = Trainer(model, TrainConfig(val_in_train_mode=True, **STEP),
                         device=None if mesh else "cpu", mesh=mesh)
            torch.manual_seed(3)
            out.append((float(tr.eval_step(x, y)), tr.model.state_dict()))
        (l1, s1), (l8, s8) = out
        assert l8 == pytest.approx(l1, rel=1e-6), n
        for k in s1:
            if n == 5:
                assert torch.equal(s8[k], s1[k]), k
            torch.testing.assert_close(s8[k], s1[k], rtol=1e-5, atol=1e-6)


# -- tensor parallelism --------------------------------------------------------

def test_tp_mesh_loss_equals_replicated():
    """A (data=4, model=2) mesh splits the attention's heads and the
    MLPs over the model axis: the loss equals the replicated one, dropout
    on (float32, 1e-5; the gradients are held at the layer's level in
    float64 above)."""
    make = lambda: SimpleUNetDoubleSelfAttn(**MICRO)
    batch = _batch(8, seed=2)
    loss_ref, _, _ = _step(make, batch, cpu_mesh(1))
    loss_tp, _, _ = _step(make, batch, cpu_mesh(8, model_axis=2))
    assert abs(loss_tp - loss_ref) < 1e-5, (loss_tp, loss_ref)


def test_tp_specs_name_the_jax_parameters():
    """``tensor_parallel_param_specs`` shards the parameters that the
    JAX policy shards, along the same axis once flax's (in, out) kernels
    are torch's (out, in) weights: each JAX leaf is filled with its index
    along the sharded axis and carried through the weight bridge."""
    jm = JaxSAUnet(**SAUNET)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 6, 75, 216)),
        train=False))
    specs = jparallel.tensor_parallel_param_specs(shapes["params"])

    def marked(s, spec):
        axes = [i for i, a in enumerate(spec) if a == "model"]
        if not axes:
            return np.zeros(s.shape, np.float32)
        ramp = np.arange(s.shape[axes[0]], dtype=np.float32) + 1
        view = [1] * len(s.shape)
        view[axes[0]] = -1
        return np.broadcast_to(ramp.reshape(view), s.shape).copy()

    params = jax.tree.map(marked, shapes["params"], specs,
                          is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes["batch_stats"])
    bridged = state_dict_from_flax({"params": params, "batch_stats": stats})
    want = {}
    for name, a in bridged.items():
        a = np.asarray(a)
        if a.any():
            want[name] = next(d for d in range(a.ndim)
                              if np.unique(a, axis=d).shape[d] > 1)
    got = {k: d for k, d in tensor_parallel_param_specs(
        SimpleUNetDoubleSelfAttn(**SAUNET)).items() if d is not None}
    assert got == want
    assert {"attention1.attn.in_proj_weight", "attention1.attn.out_proj.weight",
            "attention1.mlp.0.weight", "attention1.mlp.2.weight"} <= set(got)


# -- sharded windowed inference ------------------------------------------------

def test_sharded_framewise_grouped_matches_jax_and_single_device():
    """Grouped cross-batch attention: 77 frames on 8 shards of 4
    windows (2 super-batches of 32, then a tail of 13 in 3 groups of 4
    and 1) against the port's single-device protocol (batch 4, plain
    cross_batch) and the JAX package's sharded function."""
    variables = _jax_train_steps.golden_variables()
    plain = SimpleUNetDoubleSelfAttn(**TINY)
    plain.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_flax(variables).items()})
    grouped = SimpleUNetDoubleSelfAttn(**TINY, attn_mode="cross_batch:4")
    grouped.load_state_dict(plain.state_dict())
    inputs = np.random.RandomState(9).rand(6, 77, 216).astype(np.float32)
    x = torch.from_numpy(inputs)
    want = predict_framewise(plain.eval(), x, batch_size=4)
    got = predict_framewise_sharded(grouped.eval(), x, cpu_mesh(8),
                                    per_device_batch=4, group=4)
    assert got.shape == want.shape == (77, 72)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    jm = JaxSAUnet(**{**TINY, "attn_mode": "cross_batch:4"})
    theirs = jax_predict_framewise_sharded(
        lambda v, xw: jm.apply(v, xw, train=False), variables, inputs,
        jparallel.make_mesh(8), per_device_batch=4, group=4)
    np.testing.assert_allclose(got.numpy(), theirs, atol=2e-5)


def test_sharded_framewise_batch_independent_any_batching():
    """A model without batch coupling shards exactly for any per-device
    batch: 97 frames, 8 shards of 5."""
    jm = JaxBasicCnn(**CNN)
    inputs = np.random.RandomState(3).rand(6, 97, 216).astype(np.float32)
    variables = seeded_variables(jm, np.zeros((1, 6, 75, 216), np.float32),
                                 seed=1, train=False)
    model = BasicCnnSegmSigmoid(**CNN)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_flax(variables).items()})
    x = torch.from_numpy(inputs)
    want = predict_framewise(model.eval(), x, batch_size=50)
    got = predict_framewise_sharded(model, x, cpu_mesh(8),
                                    per_device_batch=5,
                                    batch_independent=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    theirs = jax_predict_framewise_sharded(
        lambda v, xw: jm.apply(v, xw, train=False), variables, inputs,
        jparallel.make_mesh(8), per_device_batch=5, batch_independent=True)
    np.testing.assert_allclose(got.numpy(), theirs, atol=2e-5)


def test_sharded_framewise_requires_composition_declaration():
    model = BasicCnnSegmSigmoid(**CNN).eval()
    with pytest.raises(ValueError, match="batch_independent"):
        predict_framewise_sharded(model, torch.zeros(6, 20, 216),
                                  cpu_mesh(8))


def test_runner_test_phase_shards_over_data_mesh(tmp_path):
    """With a 4-shard mesh the runner's test phase dispatches through
    ``predict_framewise_sharded`` (cross-batch attention regrouped to the
    test batch of 5: 2 super-batches of 20 and a tail per 45-frame file)
    and reproduces the single-device predictions and measures (the JAX
    package's tests/test_experiments.py:572, at smaller widths)."""
    cfg = shrink_for_smoke(load_experiment(
        "exp180d_musicnet_unet_extremelylarge_doubleselfattn"))
    cfg = dataclasses.replace(cfg, test_batch_size=5, model_kwargs={
        **cfg.model_kwargs, **MICRO})
    corpus = SyntheticCorpus(cfg, frames=45, n_train_files=1)
    kw = dict(do_train=False, do_val=False, store_predictions=True,
              store_results_filewise=False)
    single = run_experiment(cfg, corpus, str(tmp_path / "single"),
                            logger=logging.getLogger("shard_single"),
                            device="cpu", **kw)
    log = logging.getLogger("shard_mesh")
    log.setLevel(logging.INFO)
    records = []

    class Capture(logging.Handler):
        def emit(self, r):
            records.append(r.getMessage())

    log.addHandler(Capture())
    sharded = run_experiment(cfg, corpus, str(tmp_path / "mesh"),
                             mesh=cpu_mesh(4), logger=log, **kw)
    assert any("Test dispatch sharded over 4 data devices" in m
               for m in records)
    for s_sub, m_sub in zip(single["subsets"], sharded["subsets"]):
        assert s_sub["n_files"] == m_sub["n_files"] > 0
        for key in s_sub["framewise_mean"]:
            assert m_sub["framewise_mean"][key] == pytest.approx(
                s_sub["framewise_mean"][key], abs=1e-5), key
    files = sorted((tmp_path / "single" / "predictions" / cfg.name)
                   .glob("*.npy"))
    assert files
    for p in files:
        b = np.load(tmp_path / "mesh" / "predictions" / cfg.name / p.name)
        np.testing.assert_allclose(b, np.load(p), atol=2e-5)


def test_run_experiment_trains_over_the_default_mesh(tmp_path, monkeypatch):
    """``run_experiment`` without ``device`` or ``mesh`` trains over
    ``default_mesh()`` (here 4 CPU shards stand for 4 cards) and runs its
    test phase on one device, as the JAX runner does without a mesh."""
    from multipitch_architectures_tpu_torch.experiments import runner

    cfg = shrink_for_smoke(load_experiment(
        "exp180d_musicnet_unet_extremelylarge_doubleselfattn"))
    cfg = dataclasses.replace(
        cfg, test_batch_size=5, train_stride=10,
        model_kwargs={**cfg.model_kwargs, **MICRO},
        train_config=dataclasses.replace(cfg.train_config, batch_size=6))
    trainers = []

    class Recorded(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    mesh = cpu_mesh(4)
    monkeypatch.setattr(runner, "default_mesh", lambda: mesh)
    monkeypatch.setattr(runner, "Trainer", Recorded)
    log = logging.getLogger("default_mesh_run")
    log.setLevel(logging.INFO)
    records = []

    class Capture(logging.Handler):
        def emit(self, r):
            records.append(r.getMessage())

    log.addHandler(Capture())
    out = run_experiment(cfg, SyntheticCorpus(cfg, frames=120),
                         str(tmp_path), logger=log, max_epochs_override=1,
                         store_predictions=False,
                         store_results_filewise=False)
    assert [t.mesh for t in trainers] == [mesh]
    assert trainers[0].step > 0 and np.isfinite(
        out["history"]["train_loss"]).all()
    assert out["subsets"] and not any("Test dispatch sharded" in m
                                      for m in records)


# -- checkpoints ---------------------------------------------------------------

class _Toy(nn.Sequential):
    """A cheap model with BatchNorm statistics and dropout,
    (B, 6, 75, 216) -> (B, 1, 1, 72)."""

    def __init__(self):
        super().__init__(nn.Conv2d(6, 4, (75, 3), stride=(1, 3)),
                         nn.BatchNorm2d(4), nn.ReLU(), nn.Dropout(0.2),
                         nn.Conv2d(4, 1, 1), nn.Sigmoid())


def _fit(mesh, epochs, ckpt, start_epoch=0, restore=False):
    batches = [_batch(5, seed=s) for s in range(2)]
    cfg = TrainConfig(max_epochs=epochs, batch_size=5, seed=3, **STEP)
    tr = Trainer(_Toy(), cfg, device=None if mesh else "cpu",
                 mesh=mesh).init()
    if restore:
        epoch, lr, _ = _Checkpointer(ckpt).restore(tr)
        assert epoch == start_epoch - 1
        tr.lr = lr
    hist = tr.fit(lambda e, s: iter(batches), checkpoint_dir=ckpt,
                  start_epoch=start_epoch)
    return tr, hist


def test_checkpoint_written_on_a_mesh_loads_on_one_device(tmp_path):
    """A checkpoint holds the single-device state: written on an 8-shard
    mesh it loads into a one-device trainer unchanged and trains on
    there, and resuming on the mesh repeats the straight mesh run bit for
    bit."""
    mesh = cpu_mesh(8)
    straight, h_straight = _fit(mesh, 2, str(tmp_path / "straight"))
    first, _ = _fit(mesh, 1, str(tmp_path / "ck"))
    one = Trainer(_Toy(), TrainConfig(), device="cpu")
    _Checkpointer(str(tmp_path / "ck")).restore(one)
    for k, v in first.model.state_dict().items():
        assert torch.equal(one.model.state_dict()[k], v), k
    shutil.copytree(tmp_path / "ck", tmp_path / "ck_one")
    on_one, h_one = _fit(None, 2, str(tmp_path / "ck_one"), start_epoch=1,
                         restore=True)
    assert np.isfinite(h_one["train_loss"]).all() and on_one.step == 4
    resumed, h_resumed = _fit(mesh, 2, str(tmp_path / "ck"), start_epoch=1,
                              restore=True)
    assert h_resumed["train_loss"] == h_straight["train_loss"][1:]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


# -- the collectives ------------------------------------------------------------

@pytest.mark.parametrize("per_shard", [(1, 3, 4, 5), (3, 2, 7)])
def test_sharded_dropout_of_a_padded_batch_is_the_unpadded_batchs(per_shard):
    """5 real samples padded to 8 on 8 shards (one sample each; 3 rows
    per sample where a layer folds other dims into the batch): the real
    rows' mask is a one-device ``F.dropout`` of the 5 samples' rows from
    the same generator state, each padded row's mask is its source
    row's, and the generator then stands where the unpadded draw leaves
    it."""
    mesh = cpu_mesh(8)

    def draw(i):
        return dropout(torch.ones(per_shard, dtype=torch.float64), 0.5)

    torch.manual_seed(3)
    masks = torch.cat(run_shards(mesh, mesh.cells(), draw, batch=(5, 8)))
    after = torch.rand(4)
    rows = per_shard[0]
    torch.manual_seed(3)
    want = F.dropout(torch.ones((5 * rows,) + per_shard[1:],
                                dtype=torch.float64), 0.5, True)
    assert torch.equal(after, torch.rand(4))
    assert torch.equal(masks[:5 * rows], want)
    for j in range(5 * rows, 8 * rows):
        assert torch.equal(masks[j], masks[j % (5 * rows)]), j
    assert 0 < float((want == 0).double().mean()) < 1

def test_a_failing_shard_fails_the_call_without_hanging():
    """One shard raising, or ending before a collective that the others
    wait at, fails the whole call instead of leaving them waiting."""
    mesh = cpu_mesh(4)
    result = {}

    def call(fn):
        try:
            run_shards(mesh, mesh.cells(), fn)
        except BaseException as e:
            result["error"] = e

    def boom(i):
        if i == 2:
            raise KeyError("shard 2")
        return all_reduce(torch.ones(3), "data")

    def diverge(i):
        return None if i == 0 else all_reduce(torch.ones(3), "data")

    for fn, kind in ((boom, KeyError), (diverge, RuntimeError)):
        result.clear()
        t = threading.Thread(target=call, args=(fn,), daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert isinstance(result["error"], kind), result
    sums = run_shards(mesh, mesh.cells(),
                      lambda i: all_reduce(torch.full((2,), float(i)),
                                           "data"))
    assert all(torch.equal(s, torch.full((2,), 6.0)) for s in sums)
