"""Faults planted in the timed path underneath a run, for the checks that
``correct`` has to fail: an answer altered where it is produced, a
training step that leaves its state unchanged, a step on half of the
batch (its loss the mean over that half). A training fault may begin
only once the trainer has made ``after`` steps: after set-up, inside the
window. The int8 serving mode's faults: weights quantized to 4 bits
(``weights_4bit``); the scales of the first recording that fills a
calibration batch reused for every later one (``first_scales_reused``);
dynamic scales, each convolution's max |input| of each call
(``dynamic_scales``); the model served in float32 (``float32_served``);
and the float32 layers computed in TF32 (``tf32_rest``: the port's
``set_f32_parity`` turns TF32 on)."""

import contextlib


@contextlib.contextmanager
def planted(name, after=0):
    """The port with fault ``name`` (None: no fault) for the block; a
    training fault from the trainer's step ``after`` (from 0) on."""
    import multipitch_architectures_tpu_torch.eval as port_eval
    import multipitch_architectures_tpu_torch.eval.quant as port_quant
    import torch
    from multipitch_architectures_tpu_torch.train.trainer import Trainer

    if name is None:
        yield
        return
    patches, cleanups = [], []
    if name == "altered_answer":
        for owner, attr in ((port_eval, "predict_framewise"),
                            (port_quant, "predict_framewise_int8")):
            def fault(*args, real=getattr(owner, attr), **kwargs):
                out = real(*args, **kwargs)
                out[out.shape[0] // 2, 7] += 0.01
                return out
            patches.append((owner, attr, fault))
    elif name == "weights_4bit":
        def fault(w):
            return torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) \
                / port_quant._constant(7.0, w)
        patches.append((port_quant, "_weight_scales", fault))
    elif name == "first_scales_reused":
        real_entry = port_quant.predict_framewise_int8
        real_scales = port_quant._scales_from_maxes
        held = {}

        def entry(model, inputs, *args, batch_size=50, **kwargs):
            held["full"] = inputs.shape[1] >= batch_size
            return real_entry(model, inputs, *args, batch_size=batch_size,
                              **kwargs)

        def scales(maxes, margin, per_channel):
            if "scales" in held:
                return held["scales"]
            out = real_scales(maxes, margin, per_channel)
            if held.get("full") and any(float(v.max()) > 0
                                        for v in maxes.values()):
                held["scales"] = out
            return out
        patches += [(port_quant, "predict_framewise_int8", entry),
                    (port_quant, "_scales_from_maxes", scales)]
    elif name == "dynamic_scales":
        patches.append((port_quant, "_scales_from_maxes",
                        lambda maxes, margin, per_channel: {}))
    elif name == "tf32_rest":
        import multipitch_architectures_tpu_torch as port

        b = torch.backends
        before = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)

        def fault():
            b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True

        def restore():
            b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = before
        patches.append((port, "set_f32_parity", fault))
        cleanups.append(restore)
    elif name == "float32_served":
        patches.append((port_quant, "quantize_convs",
                        lambda model, *args, **kwargs: model))
    elif name == "frozen_step":
        real = Trainer.train_step

        def fault(self, x, y, w=None):
            if self.step < after:
                return real(self, x, y, w)
            self.model.train()
            with torch.no_grad():
                loss = self._loss(self.model(x), y, w)
            self.step += 1
            return loss
        patches.append((Trainer, "train_step", fault))
    elif name == "half_batch":
        real = Trainer.train_step

        def fault(self, x, y, w=None):
            if self.step < after:
                return real(self, x, y, w)
            n = x.shape[0] // 2
            return real(self, x[:n], y[:n])
        patches.append((Trainer, "train_step", fault))
    else:
        raise ValueError(f"unknown fault {name!r}")
    reals = [(owner, attr, getattr(owner, attr))
             for owner, attr, _ in patches]
    for owner, attr, fault in patches:
        setattr(owner, attr, fault)
    try:
        yield
    finally:
        for owner, attr, real in reals:
            setattr(owner, attr, real)
        for restore in cleanups:
            restore()
