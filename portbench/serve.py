"""Serving cells: whole recordings or short clips, each request the body
of the port's ``experiments/predict.py`` ``predict_pretrained`` with the
model held in memory:

1. ``dsp.compute_efficient_hcqt`` on the card (its tuning estimated on
   the host), host numpy (bins, T, harmonics) back;
2. the transpose to (harmonics, T, bins), copied to the card;
3. ``eval.predict_framewise`` with the configuration's fused batch and
   attention group;
4. the prediction copied to the host.

A closed loop (one client) sends the next request when the last one is
done; an open loop sends each at its due time whether or not the server
is free, and a request's latency runs from its due time.
"""

import math
import time

import numpy as np
import torch

from . import inputs, traffic, weights
from .common import stream
from .reference import frontend, protocol
from .reference.saunet import build as build_reference

HCQT_KEYS = ("fs", "fs_hcqt_target", "bins_per_octave", "num_octaves",
             "num_harmonics", "num_subharmonics", "center_bins")


class Program:
    """The port's model, built from the configuration's widths, and its
    request path."""

    def __init__(self, cfg, sd, device, tracer):
        from multipitch_architectures_tpu_torch.dsp import \
            compute_efficient_hcqt
        from multipitch_architectures_tpu_torch.eval import predict_framewise
        from multipitch_architectures_tpu_torch.experiments.configs import \
            build_model

        m = cfg["model"]
        with torch.device(device):
            net = build_model(m["class"], m["args"], attn_mode=m["attn_mode"])
        net.load_state_dict(sd, strict=True)
        # buffers that the model computes (the positional table) too
        self.net = net.to(device).eval()
        self.hcqt = compute_efficient_hcqt
        self.predict = predict_framewise
        self.cfg, self.device, self.tracer = cfg, device, tracer
        self.fe = cfg["frontend"]

    def forward(self, x):
        """The protocol's call of the model on a batch of windows."""
        return self.predict(self.net, x, context=self.fe["context"],
                            batch_size=self.cfg["serve"]["batch_size"],
                            compression=self.fe["compression"],
                            group=self.cfg["serve"]["group"])

    def __call__(self, audio, request=None):
        """(HCQT (bins, T, harmonics), prediction (T, bins)) numpy."""
        span = self.tracer.span
        with span("frontend", request):
            f, _, _ = self.hcqt(audio, device=self.device,
                                **{k: self.fe[k] for k in HCQT_KEYS})
        with span("protocol", request):
            x = torch.from_numpy(np.ascontiguousarray(
                np.transpose(f, (2, 1, 0)), np.float32)).to(self.device)
            with torch.no_grad():
                out = self.forward(x).cpu().numpy()
        return f, out

    def free(self):
        del self.net


class Control(Program):
    """The reference in the program's place, computed in TF32: what the
    output check has to reject."""

    def __init__(self, cfg, sd, device, tracer):
        self.ref = build_reference(cfg["model"]).to(device).eval()
        self.ref.load_state_dict(sd)
        self.cfg, self.device, self.tracer = cfg, device, tracer
        self.fe = cfg["frontend"]

    def forward(self, x):
        return None

    def __call__(self, audio, request=None):
        with tf32(True):
            h, p = protocol.transcribe(self.ref, audio, self.fe,
                                       self.device,
                                       self.cfg["serve"]["group"])
        return (np.transpose(h.cpu().numpy(), (2, 1, 0)),
                p.cpu().numpy())

    def free(self):
        del self.ref


class tf32:
    def __init__(self, on):
        self.on = on

    def __enter__(self):
        b = torch.backends
        self.before = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.before


def frames(seconds, fe):
    """HCQT frames of ``seconds`` of audio."""
    hop = frontend.plans(fe, 0.0)[1]
    return int(seconds * fe["fs"]) // hop + 1


def batch_sizes(t, batch, group):
    """The protocol's batch sizes for a recording of ``t`` frames: full
    batches, the tail's whole groups, the remainder."""
    out = []
    while t > 0:
        n = min(batch, t)
        if batch > n > group:
            n = n // group * group
        out.append(n)
        t -= n
    return out


def warm_up(prog, pool, cfg, device):
    """Every batch size the pool's requests drain through, once, and the
    frontend on one second of the pool's first recording."""
    fe, sv = cfg["frontend"], cfg["serve"]
    sizes = sorted({n for a in pool for n in batch_sizes(
        frames(len(a) / fe["fs"], fe), sv["batch_size"], sv["group"])})
    x = torch.zeros((fe["num_harmonics"] + fe["num_subharmonics"], 1,
                     fe["bins_per_octave"] * fe["num_octaves"]),
                    device=device)
    with torch.no_grad():
        for n in sizes:
            prog.forward(x.expand(-1, n, -1).contiguous())
    prog(pool[0][:fe["fs"]])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return sizes


def setup(run, control=False):
    cfg, mix, dev = run.cfg, run.mix, run.device
    fe = cfg["frontend"]
    run.requests_plan = traffic.requests(mix, run.seed, run.seconds)
    pool = inputs.audio_pool([s for s, _ in run.requests_plan], run.seed,
                             fe["fs"], dev)
    with torch.device("meta"):
        ref = build_reference(cfg["model"])
    sd = weights.draw(ref, run.seed, dev, cfg["weights_law"])
    prog = (Control if control else Program)(cfg, sd, dev, run.tracer)
    run.warm_sizes = warm_up(prog, pool, cfg, dev)
    return prog, pool, sd


def window(run, prog, pool):
    """The measured window: run.requests gets one dict per request."""
    mix, fe = run.mix, run.cfg["frontend"]
    reqs, outs = [], []
    run.tracer.start()
    t0 = time.perf_counter()
    run.window_start = t0
    if mix["loop"] == "closed":
        i = 0
        while time.perf_counter() < t0 + run.seconds:
            k = i % len(pool)
            start = time.perf_counter()
            with run.tracer.span("request", i):
                out = prog(pool[k], i)
            end = time.perf_counter()
            reqs.append(dict(index=k, audio_s=len(pool[k]) / fe["fs"],
                             due=start - t0, start=start - t0,
                             end=end - t0))
            outs.append(out)
            i += 1
    else:
        limit = t0 + run.seconds + mix.get("max_wait_s", 60.0)
        for i, (_, due) in enumerate(run.requests_plan):
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            start = time.perf_counter()
            if start > limit:
                reqs.append(dict(index=i, audio_s=len(pool[i]) / fe["fs"],
                                 due=due, start=None, end=None))
                outs.append(None)
                continue
            with run.tracer.span("request", i):
                out = prog(pool[i], i)
            end = time.perf_counter()
            reqs.append(dict(index=i, audio_s=len(pool[i]) / fe["fs"],
                             due=due, start=start - t0, end=end - t0))
            outs.append(out)
    run.window_end = time.perf_counter() - t0
    run.tracer.stop()
    run.requests = reqs
    return outs


def check(run, sd, pool, outs):
    """Run the reference over a sample of the finished requests, drawn
    from the seed with the longest in it, and return the compared numbers
    with their limits."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    done = [i for i, o in enumerate(outs) if o is not None]
    sample = mix["check"]
    by_len = sorted(done, key=lambda i: -run.requests[i]["audio_s"])
    picks = by_len[:sample["longest"]]
    rest = [i for i in done if i not in picks]
    rng = stream(run.seed, 5)
    picks += [rest[j] for j in rng.permutation(len(rest))[
        :sample["random"]]]
    ref = build_reference(cfg["model"]).to(dev).eval()
    ref.load_state_dict(sd)
    fe = cfg["frontend"]
    worst_h, worst_p = 0.0, 0.0
    with tf32(False):
        for i in picks:
            h, p = protocol.transcribe(ref, pool[run.requests[i]["index"]],
                                       fe, dev, cfg["serve"]["group"])
            h = h.cpu().numpy()
            f, out = outs[i]
            hp = np.transpose(f, (2, 1, 0))
            if hp.shape != h.shape or out.shape != p.shape:
                return _numbers(math.inf, math.inf, cfg, len(picks))
            worst_h = max(worst_h, float(np.abs(hp - h).max()
                                         / np.abs(h).max()))
            worst_p = max(worst_p, float(np.abs(out - p.cpu().numpy())
                                         .max()))
    return _numbers(worst_h, worst_p, cfg, len(picks))


def _numbers(h, p, cfg, n):
    lim = cfg["limits"]
    return {"hcqt_rel": [h, lim["hcqt_rel"]],
            "pred_abs": [p, lim["pred_abs"]],
            "requests_compared": [n, None]}


def attempted(run):
    return len(run.requests)


def failed(run):
    return sum(r["end"] is None for r in run.requests)
