"""The JAX side of the trainer parity in tests/test_torch_train.py and
tests/test_torch_parallel.py.

Three steps of the JAX package's ``Trainer._train_step`` and one
``_eval_step`` in train mode (``val_in_train_mode``), on the protocol
golden's tiny SAUnet with its attention dropout at 0, in float64:

    python tests/_jax_train_steps.py OUT.npz

or, with ``--mesh8``, one step of the same model at batch 5 on an
8-device data mesh (virtual CPU devices), the batch padded to 8 by the
trainer's ``_shard``:

    python tests/_jax_train_steps.py --mesh8 OUT.npz

It runs as a process of its own so that XLA compiles with its default
optimisation: the test suite's conftest turns that off, and float64
convolutions then run several times slower. OUT.npz holds the batches,
the losses and the flax variables after the steps and after the
validation forward (flattened, '/'-joined paths).
"""

import os
import sys

import numpy as np

TINY = dict(n_chan_layers=(8, 8, 4, 2), n_bins_out=72, scalefac=16,
            embed_dim=32, num_heads=8, mlp_dim=64, pos_encoding="sinusoidal",
            p_dropout=0.0)
# batch 2 (the least the cross-batch attention takes), per-sample loss
# weights; AdamW eps 1e-4 (see tests/test_torch_train.py)
TRAIN_CONFIG = dict(batch_size=2, scheduler=None, early_stopping=False,
                    eps=1e-4, val_in_train_mode=True)
# the padded data-parallel step: 5 samples on 8 shards
MESH_TRAIN_CONFIG = dict(batch_size=5, scheduler=None, early_stopping=False,
                         eps=1e-4)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "predict_framewise_golden.npz")


def batches():
    """3 training batches and one validation batch: (x, y, w) float64."""
    rng = np.random.RandomState(0)
    return [(np.log1p(10 * rng.rand(2, 6, 75, 216)),
             (rng.rand(2, 1, 1, 72) > 0.9).astype(np.float64),
             np.array([1.0, 0.5])) for _ in range(4)]


def mesh_batch():
    """The batch of the 8-shard step: (x, y) float64, 5 samples."""
    rng = np.random.RandomState(2)
    return (np.log1p(10 * rng.rand(5, 6, 75, 216)),
            (rng.rand(5, 1, 1, 72) > 0.9).astype(np.float64))


def golden_variables():
    from flax import serialization

    g = np.load(GOLDEN)
    return serialization.msgpack_restore(g["variables_msgpack"].tobytes())


def no_attn_dropout_model():
    """The tiny SAUnet with its attention layers' dropout at 0."""
    import flax.linen as fnn

    from multipitch_architectures_tpu.models import layers as jl
    from multipitch_architectures_tpu.models import unets as ju

    class NoAttnDropout(ju.SimpleUNetDoubleSelfAttn):
        """``SimpleUNetDoubleSelfAttn.__call__`` with ``p_dropout=0.0``
        passed to both ``TransformerEncLayer``s (their own default is
        0.2); names and parameters unchanged."""

        @fnn.compact
        def __call__(self, x, train: bool = False):
            enc, dec = ju._std_geometry(self.scalefac, self.n_chan_layers[0])
            x = jl.HarmonicLayerNorm(name="layernorm")(ju._to_nhwc(x))
            x1, x2, x3, x4, x5 = ju._encode(
                x, enc, (2, 2), train, convdrop=self.convdrop,
                residual=self.residual, alt_order=self.alt_order)
            for name, pe in (("attention1", self.pos_encoding),
                             ("attention2", None)):
                x5 = jl.TransformerEncLayer(
                    self.embed_dim, self.num_heads, self.mlp_dim,
                    p_dropout=0.0, pos_encoding=pe,
                    attn_mode=self.attn_mode, name=name)(x5, train)
            h = ju._decode(x5, [x4, x3, x2, x1], dec, (2, 2), train,
                           convdrop=self.convdrop, residual=self.residual,
                           alt_order=self.alt_order)
            return ju._to_nchw(self._head(h, train))

    return NoAttnDropout(**TINY)


def _save(out, tag, params, stats):
    from flax import traverse_util

    flat = traverse_util.flatten_dict(
        {"params": params, "batch_stats": stats}, sep="/")
    out.update({f"{tag}/{k}": np.asarray(v) for k, v in flat.items()})


def _float64_state(trainer):
    import jax
    import jax.numpy as jnp

    from multipitch_architectures_tpu.train import trainer as jt

    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             golden_variables())
    return jax.device_put(jt.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=trainer.tx.init(variables["params"]), tx=trainer.tx),
        trainer._replicated)


def main_mesh8(out_path):
    """One step at batch 5 on an 8-device data mesh (``--mesh8``)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from multipitch_architectures_tpu.parallel import make_mesh
    from multipitch_architectures_tpu.train import trainer as jt

    out = {}
    with jax.enable_x64(True):
        trainer = jt.Trainer(no_attn_dropout_model(),
                             jt.TrainConfig(**MESH_TRAIN_CONFIG),
                             mesh=make_mesh(8))
        state = _float64_state(trainer)
        x, y = mesh_batch()
        xs, ys, ws = trainer._shard(jnp.asarray(x), jnp.asarray(y))
        state, loss = trainer._train_step(state, xs, ys, ws,
                                          jax.random.PRNGKey(0))
        out["loss"] = np.array(float(loss))
        out["weights"] = np.asarray(ws)
        _save(out, "after_step", state.params, state.batch_stats)
    np.savez(out_path, **out)


def main(out_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multipitch_architectures_tpu.train import trainer as jt

    out = {}
    data = batches()
    for i, (x, y, w) in enumerate(data):
        out[f"batch{i}/x"], out[f"batch{i}/y"], out[f"batch{i}/w"] = x, y, w

    with jax.enable_x64(True):
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        trainer = jt.Trainer(no_attn_dropout_model(),
                             jt.TrainConfig(**TRAIN_CONFIG), mesh=mesh)
        state = _float64_state(trainer)
        sharded = NamedSharding(mesh, P("data"))

        def put(a):
            return jax.device_put(jnp.asarray(a), sharded)

        losses = []
        for i, (x, y, w) in enumerate(data[:3]):
            state, loss = trainer._train_step(state, put(x), put(y), put(w),
                                              jax.random.PRNGKey(i))
            losses.append(float(loss))
        out["losses"] = np.array(losses)
        _save(out, "after_steps", state.params, state.batch_stats)
        x, y, w = data[3]
        loss, stats = trainer._eval_step(state.params, state.batch_stats,
                                         put(x), put(y), put(w), True,
                                         jax.random.PRNGKey(9))
        out["val_loss"] = np.array(float(loss))
        _save(out, "after_val", state.params, stats)
    np.savez(out_path, **out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if sys.argv[1] == "--mesh8":
        # before JAX is imported: 8 virtual CPU devices
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        main_mesh8(sys.argv[2])
    else:
        main(sys.argv[1])
