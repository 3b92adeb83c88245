"""Learning-rate control.

Counterpart of ``multipitch_architectures_tpu/train/schedulers.py``. The
experiments use two torch schedulers (exp180d…py:302-310), and the
reference ships an unused Noam wrapper (libdl/schedulers/
lr_schedulers.py). All three are host-side controllers that give the
next lr; the trainer writes it into the AdamW parameter group (per
epoch, and per step for Noam).
"""

import math


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics
    (the exp config: mode min, factor 0.5, patience 5, threshold 1e-4
    rel, cooldown 0, min_lr 1e-6, eps 1e-8 — exp180d…py:124-135)."""

    def __init__(self, initial_lr, mode="min", factor=0.5, patience=5,
                 threshold=1e-4, threshold_mode="rel", cooldown=0,
                 min_lr=0.0, eps=1e-8):
        if not factor < 1.0:
            raise ValueError("factor should be < 1.0")
        self.lr = initial_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.min_lr = min_lr
        self.eps = eps
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0

    def _is_better(self, a, best):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric) -> float:
        """Update with this epoch's metric; returns the (possibly reduced)
        lr to use for the next epoch."""
        if self._is_better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


def polynomial_decay_lambda(start_lr, end_lr, n_decay, exp_decay):
    """The experiments' LambdaLR polynomial decay factor
    (exp180d…py:304-306): multiply initial_lr by
    ((start-end)·(1 - min(epoch,n)/n)^p + end)."""

    def factor(epoch):
        return ((start_lr - end_lr)
                * (1 - min(epoch, n_decay) / n_decay) ** exp_decay + end_lr)

    return factor


class NoamSchedule:
    """Noam warmup rate (libdl/schedulers/lr_schedulers.py:1-39):
    rate(step) = d_model^-0.5 · min(step^-0.5, step·warmup^-1.5)."""

    def __init__(self, model_size, warmup):
        self.model_size = model_size
        self.warmup = warmup
        self._step = 1

    def rate(self, step=None) -> float:
        step = self._step if step is None else step
        return (self.model_size ** -0.5
                * min(step ** -0.5, step * self.warmup ** -1.5))

    def step(self) -> float:
        self._step += 1
        return self.rate()

    def state_dict(self):
        return {"model_size": self.model_size, "warmup": self.warmup,
                "_step": self._step}

    def load_state_dict(self, state):
        self.__dict__.update(state)

    def update_rate(self, count: int) -> float:
        """The lr of optimizer update ``count`` (0-based), with the
        reference's step semantics (lr_schedulers.py:26-39): ``noam_opt``
        starts at ``_step = 1`` and increments BEFORE computing the rate,
        so the k-th update (count k - 1) runs at ``rate(k + 1)``. The
        trainer sets it before every step; the JAX package's
        ``noam_optax_schedule`` computes the same on the device."""
        return self.rate(count + 2)


# reference-compatible alias (libdl.schedulers.noam_opt was an optimizer
# wrapper; the schedule itself is what carries over)
noam_opt = NoamSchedule
