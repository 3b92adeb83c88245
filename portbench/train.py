"""The training cell: ``Trainer.fit`` over ``TrainPipeline.batches``, as
the port's ``experiments/runner.py`` ``run_experiment`` builds them, on a
synthetic corpus made from the seed.

One ``fit`` call runs set-up and window: the feed that the benchmark
hands to ``fit`` lets the first ``setup_steps`` batches through (the
steps that the output check compares, and the warm-up), synchronises
and opens the window, and closes it at the first batch asked for after
``--seconds``, by raising :class:`WindowClosed` out of ``fit`` after a
device sync. So the steps of the check and of the window are one
trainer's, on one feed. Inside the window the feed holds a copy of the
state (parameters and AdamW moments) that each step starts from, so the
check can replay the window's last step in the reference from it.
"""

import contextlib
import time

import numpy as np
import torch

from . import common, inputs, traffic, weights
from .common import stream
from .reference import train as reference
from .serve import tf32


class WindowClosed(Exception):
    pass


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Feed:
    """The iterable that ``Trainer.fit`` consumes for one epoch."""

    def __init__(self, run, epoch, batches):
        self.run, self.epoch, self.batches = run, epoch, batches
        self.index = 0

    def __iter__(self):
        return self

    def __next__(self):
        state = self.run
        state.on_batch()
        with state.run.tracer.span("data"):
            b = next(self.batches)
        state.hand_out(self.epoch, self.index)
        self.index += 1
        return b


class TrainRun:
    """State that the feed and the step recorder share."""

    def __init__(self, run, trainer, sd, setup_steps, profile):
        self.run, self.trainer, self.sd = run, trainer, sd
        self.setup_steps = setup_steps
        self.profile_skip, self.profile_steps = profile
        self.asked = 0          # batches handed to fit
        self.first_loss = None
        self.last_loss = None
        self.first_grads = None
        self.change = None
        self.t0 = None
        self.held = None        # the state before the newest timed step
        self.last = None        # the window's last step, for the check

    def on_batch(self):
        """Called before each batch is asked for: ``asked`` steps have
        been enqueued."""
        run, n = self.run, self.asked
        if n == 1:
            self.first_grads = first_gradients(self.trainer)
        if n == 3:
            params = dict(self.trainer.model.named_parameters())
            self.change = {k: (p.detach() - self.sd[k]).clone()
                           for k, p in params.items()}
        if n == self.setup_steps:
            self.held = {k: [t.clone() for t in ts]
                         for k, ts in adamw_state(self.trainer).items()}
            _sync(run.device)
            self.t0 = time.perf_counter()
            run.window_start = self.t0
        if self.t0 is None:
            return
        k = n - self.setup_steps
        if run.trace and k == self.profile_skip:
            run.tracer.start()
        if run.trace and k == self.profile_skip + self.profile_steps:
            run.tracer.stop()
        if time.perf_counter() >= self.t0 + run.seconds:
            _sync(run.device)
            run.window_end = time.perf_counter() - self.t0
            run.tracer.stop()
            run.steps = k
            if k:
                self.last["post"] = {
                    name: [t.clone() for t in ts]
                    for name, ts in adamw_state(self.trainer).items()}
                self.last["loss"] = float(self.last_loss)
                self.last["grad"] = {
                    name: torch.zeros_like(p) if p.grad is None
                    else p.grad.clone()
                    for name, p in self.trainer.model.named_parameters()}
            raise WindowClosed
        # hold the state that the next step starts from; the copy is
        # enqueued here, before the pipeline's batch, while the host is
        # still ahead of the card
        state = adamw_state(self.trainer)
        torch._foreach_copy_([t for k in state for t in self.held[k]],
                             [t for ts in state.values() for t in ts])

    def hand_out(self, epoch, index):
        """Called as batch ``index`` of ``epoch`` goes to the step."""
        self.asked += 1
        if self.t0 is not None:
            self.last = {"epoch": epoch, "index": index,
                         "t": self.trainer.step, "pre": self.held}


def adamw_state(trainer):
    """{name: [parameter, first moment, second moment]} of the trainer,
    zero moments where AdamW holds none."""
    out = {}
    for k, p in trainer.model.named_parameters():
        st = trainer.optimizer.state.get(p)
        out[k] = [p.detach(), st["exp_avg"], st["exp_avg_sq"]] if st \
            else [p.detach(), torch.zeros_like(p), torch.zeros_like(p)]
    return out


def first_gradients(trainer):
    """Each parameter's first gradient as AdamW holds it after one step:
    its first moment over (1 - beta1); zero where it holds none."""
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    out = {}
    for k, p in trainer.model.named_parameters():
        st = trainer.optimizer.state.get(p, {})
        out[k] = (st["exp_avg"] / (1.0 - b1)).clone() if "exp_avg" in st \
            else torch.zeros_like(p)
    return out


def corpus(run):
    c = run.mix["corpus"]
    lengths = traffic.draw(c["length_frames"], int(c["files"]),
                           stream(run.seed, 6))
    return inputs.training_corpus([int(x) for x in lengths], run.seed,
                                  run.device)


def recipe(cfg):
    t = cfg["train"]
    return dict(lr=t["initial_lr"], betas=tuple(t["betas"]), eps=t["eps"],
                weight_decay=t["weight_decay"])


def setup_and_window(run, control=False):
    """Returns (sd, files, readings of the first steps and of the
    window's last step)."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    files = corpus(run)
    with torch.device("meta"):
        ref = common.reference(cfg, run.root)
    sd = weights.draw(ref, run.seed, dev, cfg["weights_law"])
    if control:
        # the window's last step: the first after set-up
        with tf32(True):
            readings = reference_steps(run, sd, training_set(run, files),
                                       int(mix["setup_steps"]) + 1)
        run.window_start = time.perf_counter()
        run.window_end, run.steps = 0.0, 0
        return sd, files, readings

    from multipitch_architectures_tpu_torch.data import (FileSpec,
                                                         TrainPipeline)
    from multipitch_architectures_tpu_torch.data.augment import AugmentConfig
    from multipitch_architectures_tpu_torch.experiments.configs import \
        build_model
    from multipitch_architectures_tpu_torch.train.trainer import (
        TrainConfig, Trainer)

    t, m = cfg["train"], cfg["model"]
    with torch.device(dev):
        net = build_model(m["class"], m["args"],
                          **{k: m[k] for k in ("attn_mode",) if k in m})
    net.load_state_dict(sd, strict=True)
    tcfg = TrainConfig(
        max_epochs=t["max_epochs"], batch_size=t["batch_size"],
        initial_lr=t["initial_lr"], betas=tuple(t["betas"]), eps=t["eps"],
        weight_decay=t["weight_decay"], scheduler=t["scheduler"],
        early_stopping=t["early_stopping"], loss=t["loss"],
        deterministic=t["deterministic"], seed=int(run.seed))
    trainer = Trainer(net, tcfg, device=dev)
    pipe = TrainPipeline([FileSpec(x, y) for x, y in files],
                         context=t["context"], stride=t["stride"],
                         augment=AugmentConfig(**t["augment"]),
                         target_slice=None, device=dev)
    state = TrainRun(run, trainer, sd, int(mix["setup_steps"]),
                     (int(mix["profile_skip"]), int(mix["profile_steps"])))
    step = trainer.train_step

    def recorded_step(x, y, w=None):
        with run.tracer.span("step"):
            loss = step(x, y, w)
        if state.first_loss is None:
            state.first_loss = loss
        state.last_loss = loss
        return loss

    trainer.train_step = recorded_step
    run.windows_per_step = t["batch_size"]
    try:
        trainer.fit(lambda epoch, seed: Feed(state, epoch, iter(pipe.batches(
            seed, t["batch_size"]))))
    except WindowClosed:
        pass
    else:
        raise RuntimeError("fit ended before the window closed")
    loss = None if state.first_loss is None else float(state.first_loss)
    run.trainer = trainer
    return sd, files, (loss, state.first_grads, state.change, state.last)


def training_set(run, files):
    t = run.cfg["train"]
    return reference.TrainingSet(files, t["context"], t["stride"],
                                 run.device)


def reference_steps(run, sd, ts, count):
    """The reference's first ``count`` steps (three or more) from the same
    weights, corpus and seeds: (the first loss, the first
    gradients, parameter change after three, the record of the last
    step as the window's)."""
    cfg, dev = run.cfg, run.device
    t = cfg["train"]
    model = common.reference(cfg, run.root).to(dev)
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    adamw = reference.AdamW(params, recipe(cfg))
    base = int(run.seed) + 1
    batches = ts.batches(reference.fold_in(base, 0, reference.TRAIN_DATA),
                         t["batch_size"], t["augment"], range(count))
    seeds = [reference.fold_in(base, 0, reference.TRAIN, n)
             for n in range(count)]
    held = {}

    def before(n):
        if n == 3:
            held["change"] = {k: (p.detach() - sd[k]).clone()
                              for k, p in params.items()}
        if n == count - 1:
            held["pre"] = {k: [p.detach().clone(), adamw.m[k].clone(),
                               adamw.v[k].clone()] for k, p in params.items()}

    with deterministic(t["deterministic"]):
        losses, grads = reference.steps(model, batches, seeds, adamw, before)
    change = held.get("change") or {k: (p.detach() - sd[k])
                                    for k, p in params.items()}
    last = {"epoch": 0, "index": count - 1, "t": count - 1,
            "pre": held["pre"], "loss": losses[-1], "grad": grads[-1],
            "post": {k: [p.detach(), adamw.m[k], adamw.v[k]]
                     for k, p in params.items()}}
    return losses[0], grads[0], change, last


@contextlib.contextmanager
def deterministic(on):
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def replay(run, sd, ts, last):
    """The reference's step from the state that the window's last step
    started from, on that step's batch and dropout seed: (loss,
    gradients, parameter change)."""
    cfg, dev = run.cfg, run.device
    t = cfg["train"]
    model = common.reference(cfg, run.root).to(dev)
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    pre = last["pre"]
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(pre[k][0])
    adamw = reference.AdamW(params, recipe(cfg),
                            m={k: pre[k][1].clone() for k in params},
                            v={k: pre[k][2].clone() for k in params},
                            t=last["t"])
    base = int(run.seed) + 1
    e, i = last["epoch"], last["index"]
    batch = ts.batches(reference.fold_in(base, e, reference.TRAIN_DATA),
                       t["batch_size"], t["augment"], [i])
    seed = reference.fold_in(base, e, reference.TRAIN, i)
    with deterministic(t["deterministic"]):
        losses, grads = reference.steps(model, batch, [seed], adamw)
    change = {k: p.detach() - pre[k][0] for k, p in params.items()}
    return losses[0], grads[0], change


def norms(d):
    return {k: float(v.double().norm()) for k, v in d.items()}


def gap(prog, ref, keys):
    """Worst leaf of |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's
    ‖ref‖); a leaf that reads 0 on both sides agrees."""
    med = float(np.median([ref[k] for k in keys]))
    worst = 0.0
    for k in keys:
        d, scale = abs(prog[k] - ref[k]), max(ref[k], med)
        worst = max(worst, d / scale if scale else
                    (0.0 if d == 0 else float("inf")))
    return worst


def moved(grads):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(np.median(list(grads.values())))
    return [k for k in grads if grads[k] >= 1e-3 * med]


def check(run, sd, files, readings):
    """The first step's loss, the first gradient's norm and the
    parameters' change after three steps; and the window's last step,
    replayed from the state it started from: its loss, the gradient that
    AdamW stepped with and the change it made. Each leaf's norm against
    the reference's."""
    loss, grads, change, last = readings
    lim = run.cfg["limits"]
    inf = float("inf")
    if None in (loss, grads, change, last):
        return {k: [inf, v] for k, v in lim.items()}
    ts = training_set(run, files)
    r_loss, r_grads, r_change, _ = reference_steps(run, sd, ts, 3)
    gp, gr = norms(grads), norms(r_grads)
    cp, cr = norms(change), norms(r_change)

    w_loss, w_grads, w_change = replay(run, sd, ts, last)
    pre, post = last["pre"], last["post"]
    w_gp, w_gr = norms(last["grad"]), norms(w_grads)
    w_cp = norms({k: post[k][0].double() - pre[k][0].double() for k in post})
    w_cr = norms(w_change)
    return {"loss1_rel": [abs(loss - r_loss) / abs(r_loss), lim["loss1_rel"]],
            "grad_norm_gap": [gap(gp, gr, list(gr)), lim["grad_norm_gap"]],
            "change_norm_gap": [gap(cp, cr, moved(gr)),
                                lim["change_norm_gap"]],
            "window_loss_rel": [abs(last["loss"] - w_loss) / abs(w_loss),
                                lim["window_loss_rel"]],
            "window_grad_gap": [gap(w_gp, w_gr, list(w_gr)),
                                lim["window_grad_gap"]],
            "window_change_gap": [gap(w_cp, w_cr, moved(w_gr)),
                                  lim["window_change_gap"]],
            "leaves_left_out": [len(gr) - len(moved(gr)), None],
            "window_step": [last["t"] + 1, None],
            "window_grad_norm": [float(np.sqrt(sum(
                v * v for v in w_gr.values()))), None]}


def attempted(run):
    return run.steps


def failed(run):
    return 0
