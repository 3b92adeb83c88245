"""Faults planted in the timed path underneath a run, for the checks that
``correct`` has to fail: an answer altered where it is produced, a
training step that leaves its state unchanged, a step on half of the
batch (its loss the mean over that half). A training fault may begin
only once the trainer has made ``after`` steps: after set-up, inside the
window."""

import contextlib


@contextlib.contextmanager
def planted(name, after=0):
    """The port with fault ``name`` (None: no fault) for the block; a
    training fault from the trainer's step ``after`` (from 0) on."""
    import multipitch_architectures_tpu_torch.eval as port_eval
    import torch
    from multipitch_architectures_tpu_torch.train.trainer import Trainer

    if name is None:
        yield
        return
    if name == "altered_answer":
        owner, attr = port_eval, "predict_framewise"
        real = port_eval.predict_framewise

        def fault(*args, **kwargs):
            out = real(*args, **kwargs)
            out[out.shape[0] // 2, 7] += 0.01
            return out
    elif name == "frozen_step":
        owner, attr = Trainer, "train_step"
        real = Trainer.train_step

        def fault(self, x, y, w=None):
            if self.step < after:
                return real(self, x, y, w)
            self.model.train()
            with torch.no_grad():
                loss = self._loss(self.model(x), y, w)
            self.step += 1
            return loss
    elif name == "half_batch":
        owner, attr = Trainer, "train_step"
        real = Trainer.train_step

        def fault(self, x, y, w=None):
            if self.step < after:
                return real(self, x, y, w)
            n = x.shape[0] // 2
            return real(self, x[:n], y[:n])
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(owner, attr, fault)
    try:
        yield
    finally:
        setattr(owner, attr, real)
