"""The single configurable trainer, on one device or a device mesh.

Counterpart of ``multipitch_architectures_tpu/train/trainer.py``, which
replaces the copy-pasted train/val/checkpoint loop of the reference's
111 experiment scripts (canonical anatomy: exp180d…py:290-398, SURVEY
§2.8):

- ``torch.optim.AdamW``; the host-side schedulers set the lr per epoch
  (ReduceLROnPlateau, LambdaLR) or per step (Noam);
- checkpoint on the best validation loss, plus the epoch-0 save
  (exp180d…py:372-378), of the full training state (model with its
  BatchNorm statistics, optimizer state, step, epoch, lr, metric) with
  ``torch.save``, so training can resume; the reference saved weights
  only (SURVEY §5);
- ``val_in_train_mode``: the reference never calls ``model.eval()`` for
  validation (exp180d…py:340-352), so dropout and batch-statistics
  BatchNorm stay on and each validation forward advances the BatchNorm
  running statistics, which are kept;
- deterministic resume: the data, dropout and augmentation generators
  are seeded by ``fold_in(seed + 1, epoch, stream, batch index)``, as the
  JAX package's ``fold_in`` key streams, so a resumed run replays a
  straight run's randomness; with ``TrainConfig.deterministic`` (the
  default) each step runs with ``cudnn.deterministic``, so on the card
  too a resumed run repeats a straight run bit for bit (the JAX
  package's promise, train/trainer.py:262-268). The U-Nets' upsampling
  is two products (``ops.resize``), whose backward adds in a fixed
  order.

BatchNorm is torch's, as in the reference: its running variance takes
the unbiased batch variance, where flax's takes the biased one (a factor
n/(n-1) on each update, n the elements per channel).

On a mesh (``parallel.make_mesh``; by default every visible card when
there are several, as the JAX package's trainer spans all devices), as
the JAX package's trainer: each
batch is padded to a multiple of the mesh's device count by repeating
its leading samples, with loss weight 0 (``_shard``), and split over the
``data`` axis; the step runs one replica per cell, each in its thread,
with BatchNorm statistics and cross-batch attention of the global
(padded) batch and the unpadded batch's dropout masks, each padded row
taking its source row's (``parallel.spmd``), the ``model`` axis
splitting the transformer layers' attention and MLPs; the loss is taken
on the gathered outputs, and the gradients of the replicas' parameters
sum into the model's on the mesh's first device, where the optimizer
runs. The model itself stays whole there, so a checkpoint is the
single-device state and loads on one device or another mesh.
"""

import contextlib
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import fold_in
from ..models.layers import init_parameters_flax
from ..parallel import (apply_sharded, batch_sharding, default_mesh,
                        gather_rows, reduce_grads, replicate, shard_leaves)
from .losses import bce_loss, multitask_bce_ce_loss
from .monitoring import EarlyStopping
from .schedulers import (NoamSchedule, ReduceLROnPlateau,
                         polynomial_decay_lambda)

# fold_in streams of one epoch: train dropout, validation dropout, train
# data, validation data (the JAX package's split into four keys)
_TRAIN, _VAL, _TRAIN_DATA, _VAL_DATA = range(4)


@dataclass
class TrainConfig:
    """Mirrors the experiment scripts' config blocks (exp180d…py:100-151)."""

    max_epochs: int = 100
    batch_size: int = 25
    # optimizer (AdamW, exp180d…py:107-113)
    initial_lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    # scheduler (exp180d…py:115-135)
    scheduler: Optional[str] = "ReduceLROnPlateau"   # | 'LambdaLR' | 'Noam' | None
    scheduler_params: dict = field(default_factory=dict)
    # early stopping (exp180d…py:139-144)
    early_stopping: bool = True
    es_mode: str = "min"
    es_min_delta: float = 1e-5
    es_patience: int = 12
    es_percentage: bool = False
    # loss
    loss: str = "bce"                                # | 'multitask'
    # reference quirks / caps
    val_in_train_mode: bool = False
    max_train_batches: Optional[int] = None          # 'moresamples' 3800 cap
    seed: int = 0
    # cuDNN's deterministic algorithms in every step: bit-exact resume on
    # the card, at a cost that chip_smoke.py's phase 8e measures
    deterministic: bool = True


@contextlib.contextmanager
def _cudnn_deterministic(on: bool):
    """``torch.backends.cudnn.deterministic`` on for the block when
    ``on``, restored after it."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = before or on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _same_device(a, b) -> bool:
    """``a`` and ``b`` name one device (``"cuda"`` is the current card)."""
    def full(d):
        d = torch.device(d)
        return torch.device("cuda", torch.cuda.current_device()) \
            if d.type == "cuda" and d.index is None else d
    return full(a) == full(b)


def _loss_fn_for(name: str) -> Callable:
    if name == "bce":
        def fn(outputs, y, weights):
            if isinstance(outputs, tuple):
                outputs = outputs[0]
            return bce_loss(outputs, y, weights)
        return fn
    if name == "multitask":
        return multitask_bce_ce_loss
    raise ValueError(f"unknown loss {name!r}")


class Trainer:
    """Owns the model on its device, the optimizer and the epoch loop.

    Args:
        model: an ``nn.Module`` of ``.models`` (NCHW in and out); moved
            to ``device``. Its weights stay until :meth:`init` draws new
            ones.
        config: :class:`TrainConfig`.
        logger: python logger (reference-format epoch lines).
        device: one device: the steps run unsharded there (raises for
            the card when there is none).
        mesh: a ``parallel.Mesh``: the steps run sharded over it (module
            docstring). It implies the device, its first; a ``device``
            that is another raises. With neither ``device`` nor ``mesh``
            the trainer spans every visible card on the ``data`` axis,
            as the JAX package's ``Trainer`` spans all devices
            (``parallel.default_mesh``); with one card it runs the
            one-device step there, and without one it raises.
    """

    def __init__(self, model, config: TrainConfig,
                 logger: Optional[logging.Logger] = None, device=None,
                 mesh=None):
        if mesh is None and device is None:
            mesh = default_mesh()
        if mesh is not None:
            if device is not None and not _same_device(device, mesh.device):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.logger = logger or logging.getLogger(__name__)
        self._loss = _loss_fn_for(config.loss)
        self._noam = None
        if config.scheduler == "Noam":
            # per-STEP warmup (reference noam_opt.step wraps every
            # optimizer.step, lr_schedulers.py:26-31)
            sp = dict(config.scheduler_params)
            self._noam = NoamSchedule(sp.get("model_size", 512),
                                      sp.get("warmup", 4000))
            self.lr = self._noam.update_rate(0)
        else:
            self.lr = config.initial_lr
        self._make_optimizer()
        self._make_scheduler()

    # -- setup ------------------------------------------------------------

    def _make_optimizer(self):
        cfg = self.config
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self.lr, betas=tuple(cfg.betas),
            eps=cfg.eps, weight_decay=cfg.weight_decay)
        self.step = 0

    def _make_scheduler(self):
        cfg = self.config
        sp = dict(cfg.scheduler_params)
        self.scheduler = None
        if cfg.scheduler == "ReduceLROnPlateau":
            sp.setdefault("factor", 0.5)
            sp.setdefault("patience", 5)
            sp.setdefault("threshold", 1e-4)
            sp.setdefault("min_lr", 1e-6)
            self.scheduler = ReduceLROnPlateau(cfg.initial_lr, **sp)
        elif cfg.scheduler == "LambdaLR":
            self._lambda = polynomial_decay_lambda(
                sp.get("start_lr", 1.0), sp.get("end_lr", 1e-2),
                sp.get("n_decay", 20), sp.get("exp_decay", 0.5))

    def init(self, seed: Optional[int] = None):
        """Draw initial weights as the JAX package's ``model.init`` does
        (:func:`~..models.layers.init_parameters_flax`) from a CPU
        generator seeded ``seed`` (``config.seed`` by default), so every
        device starts from the same weights; reset the optimizer state
        and the step count. Returns ``self``."""
        gen = torch.Generator().manual_seed(
            self.config.seed if seed is None else seed)
        init_parameters_flax(self.model.cpu(), gen)
        self.model.to(self.device)
        self._make_optimizer()
        return self

    # -- steps ------------------------------------------------------------

    def _shard(self, x, y, w=None):
        """Pad the batch to a multiple of the mesh's device count and
        place it over the ``data`` axis: ``(xs, ys, ws)``, each a
        ``parallel.ShardedTensor``; ``ws`` the per-sample loss weights
        (``w``, ones by default), 0 for the padding.

        The padding repeats the leading samples (wrap-around) rather than
        zeros, as the JAX package's ``Trainer._shard``: the padded rows
        carry no loss weight, but the batch-coupled computations
        (train-mode BatchNorm statistics, the cross-batch attention
        quirk) see real data. For a batch-decoupled model the loss is
        exactly the unpadded mean."""
        n = x.shape[0]
        pad = (-n) % self.mesh.size
        w = torch.ones(n, dtype=x.dtype, device=x.device) if w is None \
            else torch.as_tensor(w, dtype=x.dtype, device=x.device)
        if pad:
            reps = -(-(n + pad) // n)
            x = torch.cat([x] * reps)[:n + pad]
            y = torch.cat([y] * reps)[:n + pad]
            w = torch.cat([w, w.new_zeros(pad)])
        place = batch_sharding(self.mesh).place
        return place(x), place(y), place(w)

    def _forward(self, x, y, w):
        """(loss, leaves): the loss of the batch through the model, or on
        the mesh through its replicas (the padded batch, gathered
        outputs), whose parameters are ``leaves``
        (``parallel.shard_leaves``; None without a mesh)."""
        if self.mesh is None:
            return self._loss(self.model(x), y, w), None
        xs, ys, ws = self._shard(x, y, w)
        leaves = shard_leaves(self.model, self.mesh)
        replicas = replicate(self.model, self.mesh, params=leaves)
        out = gather_rows(apply_sharded(replicas, self.mesh, xs.shards,
                                        rows=x.shape[0]),
                          self.mesh, self.device)
        return self._loss(out, ys.gather(), ws.gather()), leaves

    def train_step(self, x, y, w=None):
        """One AdamW update on the batch ``(x, y)`` with optional
        per-sample loss weights ``w`` (B,), the model in train mode
        (dropout draws from the device's default generator; BatchNorm
        uses and advances batch statistics; on a mesh, of the padded
        global batch). Returns the loss, a 0-d tensor on the device:
        nothing waits for the card."""
        if self._noam is not None:
            self.lr = self._noam.update_rate(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with _cudnn_deterministic(self.config.deterministic):
            loss, leaves = self._forward(x, y, w)
            loss.backward()
        if leaves is not None:
            reduce_grads(self.model, self.mesh, leaves)
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, x, y, w=None):
        """The loss of ``(x, y)`` without gradients. With
        ``config.val_in_train_mode`` the model runs in train mode and the
        forward also advances the BatchNorm running statistics, which are
        kept, as the reference's validation loop does. On a mesh, a batch
        that is not a multiple of its device count runs unpadded on the
        first device in that mode (the JAX package places it replicated):
        padded rows would enter the statistics that the mode keeps."""
        self.model.train(self.config.val_in_train_mode)
        with _cudnn_deterministic(self.config.deterministic):
            if self.mesh is not None and self.config.val_in_train_mode \
                    and x.shape[0] % self.mesh.size:
                return self._loss(self.model(x), y, w)
            return self._forward(x, y, w)[0]

    # -- epoch loop -------------------------------------------------------

    def fit(self, train_batches_fn, val_batches_fn=None,
            checkpoint_dir: Optional[str] = None, start_epoch: int = 0,
            initial_best: Optional[float] = None):
        """Run the training loop.

        Args:
            train_batches_fn: callable(epoch, seed) -> iterable of (x, y)
                batches on the trainer's device (e.g. a
                ``TrainPipeline.batches`` closure); ``seed`` is a pure
                function of (config.seed, epoch).
            val_batches_fn: like train_batches_fn, or None.
            checkpoint_dir: where to save the best checkpoint.
            start_epoch: first epoch to run; ``epoch + 1`` of
                ``_Checkpointer.restore`` resumes. Every generator is a
                pure function of (seed, epoch, batch index), so a resumed
                run replays a straight run's randomness (the restored lr
                and best metric come from the checkpoint; patience
                counters restart).
            initial_best: the restored checkpoint's metric. It seeds the
                early-stopping best, so a resumed run never overwrites
                the best checkpoint with a worse first epoch.
        Returns: history dict (train_loss, val_loss, lr per epoch).
        """
        cfg = self.config
        es = EarlyStopping(cfg.es_mode, cfg.es_min_delta, cfg.es_patience,
                           cfg.es_percentage) if cfg.early_stopping else None
        if es is not None and initial_best is not None \
                and not np.isnan(initial_best):
            es.best = initial_best
        base = cfg.seed + 1
        history = {"train_loss": [], "val_loss": [], "lr": []}
        ckpt = _Checkpointer(checkpoint_dir) if checkpoint_dir else None

        for epoch in range(start_epoch, cfg.max_epochs):
            if cfg.scheduler == "LambdaLR":
                self.lr = cfg.initial_lr * self._lambda(epoch)

            accum, n_batches = 0.0, 0
            for x, y in train_batches_fn(epoch,
                                         fold_in(base, epoch, _TRAIN_DATA)):
                torch.manual_seed(fold_in(base, epoch, _TRAIN, n_batches))
                # summed in float64 on the device, as the JAX package sums
                # float(loss) on the host, without a wait per step
                accum = accum + self.train_step(x, y).double()
                n_batches += 1
                if cfg.max_train_batches and \
                        n_batches >= cfg.max_train_batches:
                    break
            train_loss = float(accum) / max(n_batches, 1)

            val_loss = None
            if val_batches_fn is not None:
                vaccum, vn = 0.0, 0
                for x, y in val_batches_fn(epoch,
                                           fold_in(base, epoch, _VAL_DATA)):
                    torch.manual_seed(fold_in(base, epoch, _VAL, vn))
                    vaccum = vaccum + self.eval_step(x, y).double()
                    vn += 1
                # an empty val iterator must not masquerade as perfect loss
                val_loss = float(vaccum) / vn if vn else None

            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["lr"].append(self.lr)
            self.logger.info(
                "Epoch #%d finished. Train Loss: %.4f%s with lr: %.5f",
                epoch, train_loss,
                f", Val Loss: {val_loss:.4f}" if val_loss is not None else "",
                self.lr)

            metric = val_loss if val_loss is not None else train_loss
            if self.scheduler is not None:
                self.lr = self.scheduler.step(metric)

            if es is not None:
                # the run's first epoch checkpoints when there is no prior
                # best (the reference's epoch-0 baseline save,
                # exp180d…py:372); a resumed run seeds es.best from the
                # checkpoint, so a WORSE first resumed epoch does not
                # clobber the restored best
                if es.best is None:
                    # patience == 0 never records a best (monitoring.py:
                    # 23-25: every epoch "is better"). A RESUMED run whose
                    # checkpoint carried no metric must NOT save
                    # unconditionally: the on-disk best may beat this
                    # epoch; wait until es.step seeds a comparable best
                    if start_epoch > 0 and epoch == start_epoch \
                            and es.patience != 0:
                        self.logger.warning(
                            "resumed without a best metric: epoch #%d is "
                            "not checkpointed unconditionally to avoid "
                            "clobbering a better on-disk best", epoch)
                    save = (epoch == start_epoch and start_epoch == 0) \
                        or es.patience == 0
                else:
                    save = es.curr_is_better(metric)
                if save:
                    if ckpt:
                        ckpt.save(self, epoch, self.lr, metric)
                    self.logger.info("  .... model of epoch #%d saved.", epoch)
                if es.step(metric):
                    break
            elif ckpt:
                ckpt.save(self, epoch, self.lr, metric)
        return history


class _Checkpointer:
    """The full training state in one ``torch.save`` file,
    ``<directory>/best.pt``: model (with BatchNorm statistics), optimizer
    state, step, epoch, lr and metric."""

    def __init__(self, directory):
        self.dir = os.path.abspath(directory)
        self.path = os.path.join(self.dir, "best.pt")

    def exists(self) -> bool:
        return os.path.isfile(self.path)

    def save(self, trainer: Trainer, epoch: int, lr: float = 0.0,
             metric: Optional[float] = None):
        os.makedirs(self.dir, exist_ok=True)
        payload = {
            "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.state_dict(),
            "step": trainer.step,
            "epoch": int(epoch),
            "lr": float(lr),
            "metric": float("nan") if metric is None else float(metric),
        }
        tmp = self.path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path)

    def restore(self, trainer: Trainer):
        """Load the checkpoint into ``trainer``; returns (epoch, lr,
        metric). Resume with ``trainer.lr = lr; trainer.fit(...,
        start_epoch=epoch + 1, initial_best=metric)``. ``lr`` is 0.0 and
        ``metric`` NaN for a checkpoint written without them."""
        # onto the CPU first: load_state_dict copies the model's tensors to
        # its device and places the optimizer state as a fresh one's
        payload = torch.load(self.path, map_location="cpu", weights_only=True)
        trainer.model.load_state_dict(payload["model"])
        trainer.optimizer.load_state_dict(payload["optimizer"])
        trainer.step = int(payload["step"])
        return (int(payload["epoch"]), float(payload.get("lr", 0.0)),
                float(payload.get("metric", math.nan)))
