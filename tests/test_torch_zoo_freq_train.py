"""One train step of the port's ``FreqUNetSelfAttn`` against the JAX
package's ``Trainer._train_step``, on the CPU, at the tiny geometry of
tests/test_torch_zoo_freq.py: both trainers in float64 (as
tests/test_torch_train.py runs them, for the same reasons: in float32 a
pooling window whose two largest values lie within the frameworks' gap
routes its gradient elsewhere), dropout 0, BatchNorm in train mode (BN
before each conv): loss rel 1e-6 and the weights after one AdamW step
(eps 1e-4) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multipitch_architectures_tpu.models import unets as ju
from multipitch_architectures_tpu.train import trainer as jt
from multipitch_architectures_tpu_torch import models as tmodels
from multipitch_architectures_tpu_torch.models import state_dict_from_flax
from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

from test_torch_zoo import _parity_settings  # noqa: F401
from test_torch_zoo import seeded_variables
from test_torch_zoo_freq import FREQ_ATTN


def test_freq_selfattn_train_step_matches_jax():
    """One step of the JAX ``Trainer._train_step`` and of the port's
    ``Trainer.train_step`` on the tiny FreqUNetSelfAttn from the same
    weights and batch, in float64, dropout 0, BatchNorm in train mode
    (BN before the conv): the losses within rel 1e-6, every weight after
    the step within 1e-5 (the running statistics follow torch's unbiased
    update, a known difference, and are not compared)."""
    kw = dict(FREQ_ATTN, p_dropout=0.0)
    rng = np.random.RandomState(1)
    x = np.log1p(10 * rng.rand(2, 6, 75, 216))
    y = (rng.rand(2, 1, 1, 72) > 0.9).astype(np.float64)
    w = np.array([1.0, 0.5])
    config = dict(batch_size=2, scheduler=None, early_stopping=False,
                  eps=1e-4)
    jm = ju.FreqUNetSelfAttn(**kw)
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), seeded_variables(
        jm, x.astype(np.float32), 7, train=False))

    tm = tmodels.FreqUNetSelfAttn(**kw).double()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    ours = Trainer(tm, TrainConfig(**config), device="cpu")
    loss = float(ours.train_step(*(torch.from_numpy(a) for a in (x, y, w))))
    after = {k: t.numpy() for k, t in tm.state_dict().items()}

    with jax.enable_x64(True):
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        trainer = jt.Trainer(jm, jt.TrainConfig(**config), mesh=mesh)
        params = jax.tree.map(jnp.asarray, v["params"])
        state = jax.device_put(jt.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
            opt_state=trainer.tx.init(params), tx=trainer.tx),
            trainer._replicated)
        put = lambda a: jax.device_put(jnp.asarray(a),
                                       NamedSharding(mesh, P("data")))
        state, jloss = trainer._train_step(state, put(x), put(y), put(w),
                                           jax.random.PRNGKey(0))
        theirs = state_dict_from_flax(jax.tree.map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
    assert loss == pytest.approx(float(jloss), rel=1e-6)
    start = state_dict_from_flax(v)
    moved = 0.0
    for k, t in theirs.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        np.testing.assert_allclose(after[k], t.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        moved = max(moved, float(np.abs(after[k] - start[k].numpy()).max()))
    assert moved > 5e-4                       # the step at lr 1e-3 moved them
