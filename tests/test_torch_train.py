"""The port's training stack against the JAX package, on the CPU.

Host controllers (early stopping, the schedulers, the Noam step rates)
must agree exactly, the losses to 1e-6. The trainer is held against the
JAX ``Trainer._train_step`` / ``_eval_step`` on the tiny SAUnet of the
protocol golden (its exact flax variables reach the port through
``state_dict_from_flax``), dropout off, in float64:

- in float32 the two frameworks' forwards differ by ~1e-6, and a
  max-pool window whose two largest values lie closer than that sends
  its gradient to another element; measured on this model, the trunk's
  gradients then differ by up to 9e-3 of their largest value (the head's
  by 1e-6), which the steps amplify. float64 removes those near-ties;
- the JAX package's bilinear upsampling uses float32 weight tables, so in
  float64 its gradients still differ from the port's by ~3e-7 relative
  (measured), and AdamW at the recipe's eps 1e-8 moves a weight whose
  gradient is near eps by a step that is steep in the gradient (up to
  8e-5 apart after 3 steps, measured). These tests use eps 1e-4, where
  that gap stays below 1e-7; the chip smoke holds the recipe's eps card
  against CPU;
- the SAUnet's attention layers keep their own dropout of 0.2 whatever
  ``p_dropout`` says (as the reference's), so the JAX side runs a copy of
  the model whose attention dropout is 0 and the port sets every
  ``nn.Dropout`` to 0.

BatchNorm: torch's running variance takes the unbiased batch variance,
flax's the biased one, so each update differs by n/(n-1) (n the elements
per channel); the statistics are compared with that factor taken out.
"""

import logging
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch import nn

import _jax_train_steps

from multipitch_architectures_tpu.models import layers as jl
from multipitch_architectures_tpu.train import losses as jlosses
from multipitch_architectures_tpu.train import monitoring as jmon
from multipitch_architectures_tpu.train import schedulers as jsched
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.data import (AugmentConfig, FileSpec,
                                                     TrainPipeline)
from multipitch_architectures_tpu_torch.models import (
    SimpleUNetDoubleSelfAttn, init_parameters_flax, state_dict_from_flax)
from multipitch_architectures_tpu_torch.train import (
    EarlyStopping, NoamSchedule, ReduceLROnPlateau, TrainConfig, Trainer,
    bce_loss, cross_entropy_logits, multitask_bce_ce_loss,
    polynomial_decay_lambda, polyphony_targets)
from multipitch_architectures_tpu_torch.train.trainer import _Checkpointer

TINY = _jax_train_steps.TINY
JAX_STEPS = _jax_train_steps.__file__
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5
STATS_RTOL, STATS_ATOL = 1e-6, 1e-8    # atol for means near 0
RECIPE = dict(transposition=5, randomeq=20, noisestd=1e-4, tuning=True,
              compression=10.0)


@pytest.fixture(autouse=True, scope="module")
def _parity_settings():
    set_f32_parity()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- host controllers and losses --------------------------------------------

def _metric_sequences():
    rng = np.random.RandomState(0)
    plateau = [1.0 * 0.99 ** min(i, 10) + 1e-6 * rng.rand() for i in range(40)]
    return [
        [1.0, 0.9, 0.95, 0.91, 0.89, 0.94, 0.93, 0.92, 0.95, 0.96, 0.97],
        plateau,
        [0.5, 0.4, float("nan"), 0.3],
        [3.0, 2.0, 2.5, 2.6, 1.0, 1.5, 1.4, 1.3, 1.2, 1.1],
    ]


@pytest.mark.parametrize("kw", [
    dict(mode="min", min_delta=1e-3, patience=2),
    dict(mode="min", min_delta=1e-3, patience=5),
    dict(mode="max", min_delta=0.0, patience=3),
    dict(mode="min", min_delta=5.0, patience=3, percentage=True),
    dict(mode="min", min_delta=0.0, patience=0),
])
def test_early_stopping_matches_jax(kw):
    """Same stop decisions and checkpoint gates, NaN stop and the
    patience-0 rule (never stops, every epoch is better) included."""
    for seq in _metric_sequences():
        ours, theirs = EarlyStopping(**kw), jmon.EarlyStopping(**kw)
        for v in seq:
            if ours.best is not None:
                assert ours.curr_is_better(v) == theirs.curr_is_better(v)
            stop = ours.step(v)
            assert stop == theirs.step(v)
            assert ours.best == theirs.best or (
                np.isnan(ours.best) and np.isnan(theirs.best))
            if stop:
                break


def test_reduce_lr_on_plateau_matches_jax_and_torch():
    kw = dict(factor=0.5, patience=5, threshold=1e-4, min_lr=1e-6)
    ours = ReduceLROnPlateau(1e-3, **kw)
    theirs = jsched.ReduceLROnPlateau(1e-3, **kw)
    lin = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW(lin.parameters(), lr=1e-3)
    tsched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="min", factor=0.5, patience=5, threshold=1e-4,
        threshold_mode="rel", cooldown=0, min_lr=1e-6, eps=1e-8)
    for m in _metric_sequences()[1] * 3:
        tsched.step(m)
        lr = ours.step(m)
        assert lr == theirs.step(m)
        assert lr == pytest.approx(opt.param_groups[0]["lr"], rel=1e-12)
    assert ours.lr < 1e-3                      # it did reduce


def test_polynomial_decay_and_noam_rates_match_jax():
    ours = polynomial_decay_lambda(1.0, 1e-2, 20, 0.5)
    theirs = jsched.polynomial_decay_lambda(1.0, 1e-2, 20, 0.5)
    assert [ours(e) for e in range(30)] == [theirs(e) for e in range(30)]
    s, j = NoamSchedule(256, 40), jsched.NoamSchedule(256, 40)
    sched = jsched.noam_optax_schedule(256, 40)
    for count in range(120):                   # crosses the warmup knee
        # the k-th update (count k - 1) runs at rate(k + 1)
        assert s.update_rate(count) == j.rate(count + 2)
        assert s.update_rate(count) == pytest.approx(float(sched(count)),
                                                     rel=1e-6)
        assert s.step() == j.step()


def _loss_inputs(seed=0, b=8):
    rng = np.random.RandomState(seed)
    p = rng.rand(b, 1, 1, 72).astype(np.float32)
    p[0, 0, 0, :4] = (0.0, 1.0, 1e-9, 1 - 1e-9)   # beyond the clip
    t = (rng.rand(b, 1, 1, 72) > 0.9).astype(np.float32)
    t[0, 0, 0, :4] = (1.0, 0.0, 1.0, 0.0)
    w = rng.rand(b).astype(np.float32)
    return p, t, w


@pytest.mark.parametrize("weighted", [False, True])
def test_bce_loss_matches_jax_and_its_gradient_clip(weighted):
    """The port clips p to [1e-7, 1 - 1e-7] as the JAX package does,
    where ``nn.BCELoss`` clamps each log at -100 instead."""
    p, t, w = _loss_inputs()
    w = w if weighted else None
    pt = torch.from_numpy(p).requires_grad_()
    got = bce_loss(pt, torch.from_numpy(t),
                   None if w is None else torch.from_numpy(w))
    want = jlosses.bce_loss(jnp.asarray(p), jnp.asarray(t),
                            None if w is None else jnp.asarray(w))
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    got.backward()
    gwant = jax.grad(lambda q: jlosses.bce_loss(
        q, jnp.asarray(t), None if w is None else jnp.asarray(w)))(
        jnp.asarray(p))
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gwant),
                               rtol=1e-5, atol=1e-9)
    assert pt.grad[0, 0, 0, :2].abs().max() == 0    # no gradient past the clip
    if w is None:
        torch_loss = float(nn.BCELoss()(torch.from_numpy(p),
                                        torch.from_numpy(t)))
        assert abs(torch_loss - float(got.detach())) > 1e-3   # the trap


def test_cross_entropy_and_multitask_losses_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 24, 1, 1).astype(np.float32)
    w = rng.rand(4).astype(np.float32)
    ok = np.array([0, 5, 23, 3])[:, None, None]
    bad = np.array([0, 5, 24, 3])[:, None, None]
    for labels in (ok, bad):
        for strict in (False, True):
            for weights in (None, w):
                got = float(cross_entropy_logits(
                    torch.from_numpy(logits), torch.from_numpy(labels),
                    None if weights is None else torch.from_numpy(weights),
                    strict=strict))
                want = float(jlosses.cross_entropy_logits(
                    jnp.asarray(logits), jnp.asarray(labels),
                    None if weights is None else jnp.asarray(weights),
                    strict=strict))
                if np.isnan(want):
                    assert np.isnan(got) and strict and labels is bad
                else:
                    assert got == pytest.approx(want, rel=LOSS_RTOL)
    p, t, w = _loss_inputs(2, b=4)
    t[1, 0, 0, :30] = 1.0                     # 30 active > 24 classes: clipped
    n_pred = rng.randn(4, 24, 1, 1).astype(np.float32)
    np.testing.assert_array_equal(
        polyphony_targets(torch.from_numpy(t)).numpy(),
        np.asarray(jlosses.polyphony_targets(jnp.asarray(t))))
    for weights in (None, w):
        got = multitask_bce_ce_loss(
            (torch.from_numpy(p), torch.from_numpy(n_pred)),
            torch.from_numpy(t),
            None if weights is None else torch.from_numpy(weights))
        want = jlosses.multitask_bce_ce_loss(
            (jnp.asarray(p), jnp.asarray(n_pred)), jnp.asarray(t),
            None if weights is None else jnp.asarray(weights))
        assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


# -- the initializer --------------------------------------------------------

def test_flax_initializer_draws_what_jax_init_draws():
    """The golden's variables are the tiny SAUnet's ``model.init``. Each
    tensor of ``init_parameters_flax`` is set equal (zeros, ones, the
    BatchNorm statistics) or, scaled by its initializer's own scale,
    pooled with its kind and held to the pooled JAX values: std within
    5 %, range within the truncation (LeCun: ±2/0.8796) or the bound
    (xavier: ±1)."""
    want = state_dict_from_flax(_jax_train_steps.golden_variables())
    model = SimpleUNetDoubleSelfAttn(**TINY)
    init_parameters_flax(model, torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    attn_weights = ("in_proj_weight", "out_proj.weight")
    pooled = {"lecun": ([], []), "xavier": ([], [])}
    for k, w in want.items():
        w, g = np.asarray(w, np.float64), got[k].double().numpy()
        assert g.shape == w.shape, k
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w, err_msg=k)   # constants
            continue
        if k.endswith(attn_weights):
            kind = "xavier"
            scale = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
        else:
            kind = "lecun"
            scale = math.sqrt(1.0 / w[0].size)
        pooled[kind][0].append(g.ravel() / scale)
        pooled[kind][1].append(w.ravel() / scale)
    for kind, (ours, theirs) in pooled.items():
        ours, theirs = np.concatenate(ours), np.concatenate(theirs)
        assert ours.std() == pytest.approx(theirs.std(), rel=0.05), kind
        bound = 2 / 0.87962566103423978 if kind == "lecun" else 1.0
        assert np.abs(ours).max() <= bound + 1e-6, kind
        assert np.abs(theirs).max() <= bound + 1e-6, kind
        assert np.abs(ours).max() > 0.9 * bound, kind


def test_learned_positional_encoding_initializer_and_bridge():
    """flax ``kaiming_uniform`` of a (max_len, E) table: U(±sqrt(6/max_len));
    the bridge carries the JAX parameter ``pe`` to the port's."""
    from multipitch_architectures_tpu_torch.models import TransformerEncLayer

    layer = TransformerEncLayer(32, 8, 64, pos_encoding="learnable")
    init_parameters_flax(layer, torch.Generator().manual_seed(1))
    bound = math.sqrt(6.0 / 600)
    assert layer.pe.shape == (600, 32)
    assert float(layer.pe.detach().abs().max()) <= bound
    assert float(layer.pe.detach().std()) == pytest.approx(bound / math.sqrt(3),
                                                  rel=0.05)
    jm = jl.TransformerEncLayer(32, 8, 64, p_dropout=0.0,
                                pos_encoding="learnable")
    x = np.random.RandomState(2).randn(2, 4, 13, 32).astype(np.float32)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    sd = state_dict_from_flax({"params": {"attention1": v["params"]}})
    layer.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(np.array(a))
                           for k, a in sd.items()})
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=2e-4, rtol=1e-2)


# -- the trainer against the JAX trainer ------------------------------------

def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def _bn_elements(model, x):
    """Elements per channel that each BatchNorm normalises over for a
    batch ``x``: the n of the unbiased variance."""
    n, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, name=name: n.__setitem__(
                    name, a[0].numel() // a[0].shape[1])))
    with torch.no_grad():
        model.eval()(x)
    for h in hooks:
        h.remove()
    return n


@pytest.fixture(scope="module")
def jax_and_port_steps(tmp_path_factory):
    """3 AdamW steps and one validation forward in train mode, on both
    trainers from the same weights and batches (float64, eps 1e-4,
    per-sample loss weights). The JAX side runs in a process of its own
    (``_jax_train_steps.py``), beside the port's."""
    path = tmp_path_factory.mktemp("jax_steps") / "steps.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen([sys.executable, JAX_STEPS, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 _jax_train_steps.golden_variables())
        batches = [tuple(torch.from_numpy(a) for a in b)
                   for b in _jax_train_steps.batches()]
        model = _no_dropout(SimpleUNetDoubleSelfAttn(**TINY)).double()
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                               state_dict_from_flax(variables).items()})
        out = {"n_bn": _bn_elements(model, batches[0][0])}
        ours = Trainer(model, TrainConfig(**_jax_train_steps.TRAIN_CONFIG),
                       device="cpu")
        out["start"] = _stats(ours)
        out["loss"] = [float(ours.train_step(*b)) for b in batches[:3]]
        after_steps = _stats(ours)
        out["val_loss"] = float(ours.eval_step(*batches[3]))
        after_val = _stats(ours)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as f:
        jax_out = dict(f)
    for i, b in enumerate(batches):            # the same batches
        np.testing.assert_array_equal(b[0].numpy(), jax_out[f"batch{i}/x"])
    out["jax_loss"] = list(jax_out["losses"])
    out["jax_val_loss"] = float(jax_out["val_loss"])
    out["after_steps"] = (after_steps, _flax_sd(jax_out, "after_steps"))
    out["after_val"] = (after_val, _flax_sd(jax_out, "after_val"))
    return out


def _stats(trainer):
    return {k: v.clone().numpy() for k, v in
            trainer.model.state_dict().items()}


def _flax_sd(saved, tag):
    """The port-layout state_dict of flax variables saved flat under
    ``tag/`` by ``_jax_train_steps.py``."""
    flat = {k[len(tag) + 1:]: v for k, v in saved.items()
            if k.startswith(tag + "/")}
    variables = traverse_util.unflatten_dict(flat, sep="/")
    return {k: np.asarray(v) for k, v in
            state_dict_from_flax(variables).items()}


def _check_running_stats(ours, theirs, before, n_bn, updates):
    """running_mean equal; running_var equal once each of ``updates``
    momentum-0.1 updates from ``before`` (ours, theirs) is scaled back
    from unbiased to biased."""
    for name, n in n_bn.items():
        np.testing.assert_allclose(ours[f"{name}.running_mean"],
                                   theirs[f"{name}.running_mean"],
                                   rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=name)
        key = f"{name}.running_var"
        got = (ours[key] - 0.9 ** updates * before[0][key]) * (n - 1) / n
        want = theirs[key] - 0.9 ** updates * before[1][key]
        np.testing.assert_allclose(got, want, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=name)


def test_train_steps_loss_matches_jax(jax_and_port_steps):
    out = jax_and_port_steps
    assert out["loss"] == pytest.approx(out["jax_loss"], rel=LOSS_RTOL)


def test_train_steps_parameters_match_jax(jax_and_port_steps):
    ours, theirs = jax_and_port_steps["after_steps"]
    start = jax_and_port_steps["start"]
    moved = 0.0
    for k, w in theirs.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        np.testing.assert_allclose(ours[k], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        moved = max(moved, float(np.abs(ours[k] - start[k]).max()))
    assert moved > 2e-3                       # 3 steps at lr 1e-3 moved them


def test_train_steps_batchnorm_statistics_match_jax(jax_and_port_steps):
    ours, theirs = jax_and_port_steps["after_steps"]
    start = jax_and_port_steps["start"]
    _check_running_stats(ours, theirs, (start, start),
                         jax_and_port_steps["n_bn"], updates=3)
    assert all(ours[k] == 3 for k in ours if k.endswith("tracked"))


def test_val_in_train_mode_statistics_match_jax(jax_and_port_steps):
    """A validation forward in train mode advances the BatchNorm
    statistics and keeps them (the reference never calls model.eval()
    in validation), and gives JAX's loss."""
    out = jax_and_port_steps
    assert out["val_loss"] == pytest.approx(out["jax_val_loss"],
                                            rel=LOSS_RTOL)
    before = jax_and_port_steps["after_steps"]
    ours, theirs = jax_and_port_steps["after_val"]
    _check_running_stats(ours, theirs, before, jax_and_port_steps["n_bn"],
                         updates=1)
    for k in theirs:                          # weights untouched
        if k.endswith(("weight", "bias")):
            np.testing.assert_array_equal(ours[k], before[0][k])


# -- the epoch loop, checkpoints and resume ---------------------------------

class _Toy(nn.Sequential):
    """A cheap stand-in with every stateful kind the trainer handles:
    BatchNorm statistics, dropout, (B, 6, 75, 216) -> (B, 1, 1, 72)."""

    def __init__(self):
        super().__init__(nn.Conv2d(6, 4, (75, 3), stride=(1, 3)),
                         nn.BatchNorm2d(4), nn.ReLU(), nn.Dropout(0.2),
                         nn.Conv2d(4, 1, 1), nn.Sigmoid())


def _toy_pipelines(t=500):
    rng = np.random.RandomState(0)
    files = [FileSpec(rng.rand(6, t, 216).astype(np.float32),
                      (rng.rand(t, 120) > 0.9).astype(np.float32))]
    train = TrainPipeline(files, stride=25, augment=AugmentConfig(**RECIPE),
                          target_slice=(24, 96), device="cpu")
    val = TrainPipeline(files, stride=60, target_slice=(24, 96),
                        device="cpu")
    return train, val


def _fit(max_epochs, ckpt=None, start_epoch=0, initial_best=None,
         restore=False, **kw):
    train_p, val_p = _toy_pipelines()
    cfg = TrainConfig(**{**dict(max_epochs=max_epochs, batch_size=4,
                                seed=3, val_in_train_mode=True,
                                early_stopping=False), **kw})
    tr = Trainer(_Toy(), cfg, logger=logging.getLogger("test"),
                 device="cpu").init()
    if restore:
        epoch, lr, _ = _Checkpointer(ckpt).restore(tr)
        assert epoch == start_epoch - 1
        tr.lr = lr
    hist = tr.fit(lambda e, s: train_p.batches(s, 4),
                  lambda e, s: val_p.batches(s, 4, shuffle=False,
                                             drop_remainder=False),
                  checkpoint_dir=ckpt, start_epoch=start_epoch,
                  initial_best=initial_best)
    return tr, hist


def test_deterministic_resume_is_bitwise(tmp_path):
    """2 epochs straight == 1 epoch, checkpoint, restore into a fresh
    trainer, 1 more epoch: augmentation, shuffling, dropout and the
    validation forwards (which advance BatchNorm) all replay, bit for
    bit, and so do the losses."""
    straight, h_straight = _fit(2)
    _fit(1, ckpt=str(tmp_path / "ck"))
    resumed, h_resumed = _fit(2, ckpt=str(tmp_path / "ck"), start_epoch=1,
                              restore=True)
    assert h_resumed["train_loss"] == h_straight["train_loss"][1:]
    assert h_resumed["val_loss"] == h_straight["val_loss"][1:]
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert straight.step == resumed.step
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])


def test_resume_does_not_clobber_a_better_checkpoint(tmp_path):
    """A run seeded with a better best saves nothing; without a prior
    best the first epoch saves (the reference's epoch-0 baseline)."""
    kw = dict(early_stopping=True, es_patience=3)
    _fit(1, ckpt=str(tmp_path / "ck"), initial_best=1e-9, **kw)
    assert not _Checkpointer(str(tmp_path / "ck")).exists()
    _fit(1, ckpt=str(tmp_path / "ck2"), **kw)
    assert _Checkpointer(str(tmp_path / "ck2")).exists()


def test_legacy_resume_without_metric_does_not_save_first_epoch(
        tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="test"):
        _fit(2, ckpt=str(tmp_path / "ck"), start_epoch=1,
             early_stopping=True, es_patience=3)
    assert not _Checkpointer(str(tmp_path / "ck")).exists()
    assert "resumed without a best metric" in caplog.text


def test_restore_accepts_a_checkpoint_without_lr_and_metric(tmp_path):
    tr = Trainer(_Toy(), TrainConfig(), device="cpu").init()
    ck = _Checkpointer(str(tmp_path / "old"))
    ck.save(tr, 3, 1e-4, 0.5)
    payload = torch.load(ck.path, weights_only=True)
    del payload["lr"], payload["metric"]
    torch.save(payload, ck.path)
    fresh = Trainer(_Toy(), TrainConfig(), device="cpu").init(seed=7)
    epoch, lr, metric = ck.restore(fresh)
    assert epoch == 3 and lr == 0.0 and math.isnan(metric)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k])


def test_fit_checkpoints_on_best_logs_reference_lines_and_learns(
        tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="test"):
        tr, hist = _fit(3, ckpt=str(tmp_path / "ck"), early_stopping=True,
                        es_patience=5, initial_lr=1e-2)
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert "Epoch #0 finished. Train Loss: " in caplog.text
    assert ", Val Loss: " in caplog.text and "with lr: 0.01000" in caplog.text
    assert "  .... model of epoch #0 saved." in caplog.text
    epoch, lr, metric = _Checkpointer(str(tmp_path / "ck")).restore(tr)
    assert metric == min(hist["val_loss"][:epoch + 1])


def test_schedulers_drive_the_lr():
    """Noam warms up per STEP (the logged lr is the last update's rate);
    LambdaLR sets it per epoch; ReduceLROnPlateau cuts it after
    ``patience`` bad epochs (lr 0 cannot improve); early stopping then
    stops long before max_epochs; an empty val iterator reports None."""
    tr, hist = _fit(2, scheduler="Noam",
                    scheduler_params={"model_size": 64, "warmup": 10})
    assert tr.step >= 4 and hist["lr"][0] != hist["lr"][1]
    assert tr.lr == NoamSchedule(64, 10).rate(tr.step + 1)
    _, hist = _fit(3, scheduler="LambdaLR",
                   scheduler_params={"start_lr": 1.0, "end_lr": 1e-2,
                                     "n_decay": 2, "exp_decay": 1.0})
    assert hist["lr"] == pytest.approx([1e-3, 1e-3 * 0.505, 1e-5])
    _, hist = _fit(40, initial_lr=0.0, early_stopping=True, es_patience=2,
                   scheduler="ReduceLROnPlateau",
                   scheduler_params={"patience": 0, "min_lr": 0.0})
    assert len(hist["train_loss"]) <= 5
    tr = Trainer(_Toy(), TrainConfig(max_epochs=1, batch_size=4),
                 device="cpu").init()
    train_p, _ = _toy_pipelines(200)
    hist = tr.fit(lambda e, s: train_p.batches(s, 4), lambda e, s: iter(()))
    assert hist["val_loss"] == [None]


@pytest.mark.parametrize("deterministic", [True, False])
def test_deterministic_steps_run_with_cudnn_deterministic(deterministic):
    """``TrainConfig.deterministic`` (on by default) turns cuDNN's
    deterministic algorithms on for each train and eval step, and the
    flag is restored after it; off, the step leaves the flag as it is."""
    assert TrainConfig().deterministic is True
    seen = []

    class Probe(_Toy):
        def forward(self, x):
            seen.append(torch.backends.cudnn.deterministic)
            return super().forward(x)

    before = torch.backends.cudnn.deterministic
    tr = Trainer(Probe(), TrainConfig(deterministic=deterministic),
                 device="cpu").init()
    x = torch.rand(2, 6, 75, 216)
    y = (torch.rand(2, 1, 1, 72) > 0.9).float()
    tr.train_step(x, y)
    tr.eval_step(x, y)
    assert seen == [deterministic or before] * 2
    assert torch.backends.cudnn.deterministic == before
