"""Serving cells: whole recordings or short clips, each request the body
of the port's ``experiments/predict.py`` ``predict_pretrained`` with the
model held in memory:

1. ``dsp.compute_efficient_hcqt`` on the card (its tuning estimated on
   the host), host numpy (bins, T, harmonics) back;
2. the transpose to (harmonics, T, bins), copied to the card;
3. the configuration's serving mode (:data:`MODES`, by its
   ``precision``) with its fused batch and attention group:
   ``eval.predict_framewise`` in float32, ``eval.quant.
   predict_framewise_int8`` in int8;
4. the prediction copied to the host.

A closed loop (one client) sends the next request when the last one is
done; an open loop sends each at its due time whether or not the server
is free, and a request's latency runs from its due time.
"""

import collections
import importlib
import math
import time

import numpy as np
import torch

from . import common, inputs, traffic, weights
from .common import FLOAT32_PEAK, PEAKS, stream
from .counts import int8 as int8_counts
from .reference import frontend, protocol
from .reference import quant as quant_reference

HCQT_KEYS = ("fs", "fs_hcqt_target", "bins_per_octave", "num_octaves",
             "num_harmonics", "num_subharmonics", "center_bins")


class Float32:
    """``eval.predict_framewise``: the test protocol in float32, TF32 off.
    Its control is the reference computed in TF32."""

    entry = ("multipitch_architectures_tpu_torch.eval", "predict_framewise")

    def __init__(self, cfg):
        self.cfg = cfg

    def kwargs(self):
        return {}

    def cal(self, t):
        """(windows that a request of ``t`` frames computes in a float32
        calibration pass, frames it serves from that pass)."""
        return 0, 0

    def control(self, ref, audio, device):
        """(HCQT, predictions) of the control in the program's place."""
        with tf32(True):
            return protocol.transcribe(ref, audio, self.cfg["frontend"],
                                       device, self.cfg["serve"]["group"])

    def compare(self, ref, h, out):
        """{name: gap} of one request's predictions, the reference's from
        its own HCQT ``h``; None if the shapes differ."""
        fe = self.cfg["frontend"]
        p = protocol.predict(ref, h, fe["compression"], fe["context"],
                             self.cfg["serve"]["group"])
        if out.shape != p.shape:
            return None
        return {"pred_abs": float(np.abs(out - p.cpu().numpy()).max())}

    def numbers(self, worst, n, run):
        lim = self.cfg["limits"]
        return {"hcqt_rel": [worst["hcqt_rel"], lim["hcqt_rel"]],
                "pred_abs": [worst["pred_abs"], lim["pred_abs"]],
                "requests_compared": [n, None]}

    def window_flops(self, run, flops):
        """The work of one window served by the mode, as float32 FLOPs,
        from ``flops``, the window's float32 FLOPs."""
        return flops

    def warm(self, prog, x, lead, sizes):
        """Each batch size in ``sizes`` through the mode's entry, after
        ``lead`` frames of ``x``, a silent input long enough for all."""
        for n in sizes:
            prog.forward(x[:, :lead + n].contiguous())

    def follow(self, run, prog, sd, audio, served):
        """{name: gap} of the program followed stage by stage over one
        request once more; the float32 mode has no stage to follow."""
        return {}


class Int8(Float32):
    """``eval.quant.predict_framewise_int8`` with the configuration's
    ``quant`` block: per-recording static scales from a float32 pass over
    the first ``cal_batches`` fused batches, whose outputs serve those
    frames, then W8A8 convs on the card's int8 GEMM. Its reference and
    its control (at 4 bits) are ``reference/quant.py``."""

    entry = ("multipitch_architectures_tpu_torch.eval.quant",
             "predict_framewise_int8")
    QUANT_KEYS = ("cal_batches", "per_channel", "min_kernel_elems", "gate")
    FOLLOWED = ("int8_scale_rel", "int8_conv_sum_gap", "int8_stage_rel",
                "int8_answer_abs")

    def __init__(self, cfg):
        super().__init__(cfg)
        self.quant = {k: cfg["quant"][k] for k in self.QUANT_KEYS}

    def kwargs(self):
        return dict(self.quant)

    def cal(self, t):
        b, n = self.cfg["serve"]["batch_size"], self.quant["cal_batches"]
        return min(n, -(-t // b)) * b, min(n, t // b) * b

    def transcribe(self, ref, h, qmax=quant_reference.QMAX):
        fe, sv = self.cfg["frontend"], self.cfg["serve"]
        return quant_reference.transcribe(
            ref, h, fe["compression"], fe["context"], sv["batch_size"],
            sv["group"], self.quant, qmax)

    def control(self, ref, audio, device):
        with tf32(False):
            h = frontend.hcqt(audio, self.cfg["frontend"], device)
            cal, q = self.transcribe(ref, h, quant_reference.QMAX_CONTROL)
        return h, torch.cat([cal, q])

    def compare(self, ref, h, out):
        cal, q = self.transcribe(ref, h)
        n = cal.shape[0]
        if out.shape != (n + q.shape[0],) + tuple(q.shape[1:]):
            return None
        d = np.abs(out[n:] - q.cpu().numpy())
        return {"cal_pred_abs": float(np.abs(out[:n] - cal.cpu().numpy())
                                      .max(initial=0.0)),
                "int8_pred_abs": float(d.max(initial=0.0)),
                "int8_pred_mean_abs": float(d.mean()) if d.size else 0.0}

    def numbers(self, worst, n, run):
        lim = self.cfg["limits"]
        out = {"hcqt_rel": [worst["hcqt_rel"], lim["hcqt_rel"]]}
        for k in ("cal_pred_abs", "int8_pred_abs", "int8_pred_mean_abs"):
            out[k] = [worst[k], lim[k]]
        batches = len(served_batches(run))
        launches = run.counters.get("int8.conv_dequant_launches", 0)
        convs = len(int8_counts.convs(run.cfg, run.root))
        out["int8_conv_count_gap"] = [
            abs(convs - launches / batches) if batches else math.inf,
            lim["int8_conv_count_gap"]]
        followed = run.followed or {}
        for k in self.FOLLOWED:
            out[k] = [followed.get(k, math.inf), lim[k]]
        out["replay_pred_abs"] = [followed.get("replay_pred_abs", math.inf),
                                  None]
        out["requests_compared"] = [n, None]
        return out

    def window_flops(self, run, flops):
        """The W8A8 convs' operations at the float32 peak over the int8
        one, the rest as float32."""
        ops = sum(c[0] for c in int8_counts.convs(run.cfg, run.root))
        return flops - ops + ops * (FLOAT32_PEAK / PEAKS["int8_op_per_s"])

    def warm(self, prog, x, lead, sizes):
        """The entry once, at the largest size (a calibration pass, then
        W8A8), then each batch size through the W8A8 copy of the model
        that the entry serves with, at scales calibrated once: the
        entry's calls of ``predict_framewise`` without a calibration pass
        per size."""
        from multipitch_architectures_tpu_torch.eval import predict_framewise
        from multipitch_architectures_tpu_torch.eval import quant as port

        fe, sv, q = self.cfg["frontend"], self.cfg["serve"], self.quant
        prog.forward(x[:, :lead + sizes[-1]].contiguous())
        windows = x.new_zeros((sv["batch_size"], x.shape[0], fe["context"],
                               x.shape[2]))
        scales = port.calibrate_activation_scales(
            prog.net, [windows], q["min_kernel_elems"],
            per_channel=q["per_channel"])
        net = port.quantize_convs(prog.net, q["min_kernel_elems"], scales)
        for n in sizes:
            predict_framewise(net, x[:, :n].contiguous(),
                              context=fe["context"],
                              batch_size=sv["batch_size"],
                              compression=fe["compression"],
                              group=sv["group"])

    def follow(self, run, prog, sd, audio, served):
        """The program over one request once more, followed convolution
        by convolution (``reference/quant.py`` ``follow``): module hooks
        read each eligible convolution's input in the float32
        calibration pass, and each W8A8 convolution's input, output and
        scale in every int8 batch; the reference, fed the program's
        convolutions' inputs and outputs, runs each batch's float32
        layers, and on one batch drawn from the seed each W8A8
        convolution exactly. {name: gap}:

        - ``int8_scale_rel``: each W8A8 convolution's activation scale
          against max |its input| over the calibration pass / 127;
        - ``int8_conv_sum_gap``: that batch's W8A8 outputs against the
          reference's, in steps of the integer sums;
        - ``int8_stage_rel``: the float32 layers between them;
        - ``int8_answer_abs``: the request's int8 frames as returned
          against the reference's outputs of the same batches;
        - ``replay_pred_abs``: the request's frames as returned now
          against those returned in the window (no limit)."""
        from torch.nn.modules.module import (register_module_forward_hook,
                                             register_module_forward_pre_hook)

        fe, sv, q = self.cfg["frontend"], self.cfg["serve"], self.quant
        ref = common.reference(self.cfg, run.root).to(run.device).eval()
        ref.load_state_dict(sd)
        root = type(prog.net)
        float32 = {id(m): name for name, m in
                   quant_reference.eligible(prog.net, q["min_kernel_elems"])}
        t = frames(len(audio) / fe["fs"], fe)
        start = self.cal(t)[1]
        n_int8 = len(batch_sizes(t - start, sv["batch_size"], sv["group"]))
        exact = int(stream(run.seed, 7).integers(max(n_int8, 1)))
        state = {"batch": None, "maxes": None, "int8": 0, "outs": [],
                 "int8_scale_rel": 0.0, "int8_conv_sum_gap": 0.0,
                 "int8_stage_rel": 0.0}

        def pre(module, args):
            if type(module) is root:
                state["batch"] = {"x": args[0], "convs": {}, "maxes": {},
                                  "scales": {}}

        def post(module, args, out):
            b = state["batch"]
            if b is None:
                return
            name = float32.get(id(module))
            if name is not None:
                b["maxes"][name] = max(b["maxes"].get(name, 0.0),
                                       float(args[0].abs().max()))
            elif type(module).__name__ == "Int8Conv2d":
                b["convs"][module.name] = (args[0].clone(), out.clone())
                b["scales"][module.name] = (module.activation_scales
                                            or {}).get(module.name)
            elif type(module) is root:
                state["batch"] = None
                if b["convs"]:
                    judge(b)
                elif state["maxes"] is None:
                    state["maxes"] = b["maxes"]

        def judge(b):
            scales = quant_reference.scales_of(state["maxes"] or {},
                                               quant_reference.QMAX,
                                               run.device)
            for name, s in b["scales"].items():
                want = scales.get(name)
                rel = (math.inf if s is None or want is None
                       else abs(float(s) - float(want)) / float(want))
                state["int8_scale_rel"] = max(state["int8_scale_rel"], rel)
            with tf32(False):
                y, gaps = quant_reference.follow(
                    ref, b["x"], b["convs"], scales, sv["group"],
                    q["min_kernel_elems"], state["int8"] == exact)
            state["int8_stage_rel"] = max(state["int8_stage_rel"],
                                          gaps["stage_rel"])
            state["int8_conv_sum_gap"] = max(state["int8_conv_sum_gap"],
                                             gaps["sum_gap"])
            state["outs"].append(y.cpu().numpy())
            state["int8"] += 1

        handles = [register_module_forward_pre_hook(pre),
                   register_module_forward_hook(post)]
        try:
            _, out = prog(audio)
        finally:
            for h in handles:
                h.remove()
        found = {"replay_pred_abs": float(np.abs(out - served).max())
                 if out.shape == served.shape else math.inf}
        if state["int8"] != n_int8 or not n_int8:
            return found
        want = np.concatenate(state["outs"])
        found["int8_answer_abs"] = (float(np.abs(out[start:] - want).max())
                                    if out[start:].shape == want.shape
                                    else math.inf)
        for k in ("int8_scale_rel", "int8_conv_sum_gap", "int8_stage_rel"):
            found[k] = state[k]
        return found


MODES = {"float32": Float32, "int8": Int8}


def served_batches(run):
    """The sizes of the batches that the window's finished requests drain
    through after their calibration pass."""
    sv, fe = run.cfg["serve"], run.cfg["frontend"]
    out = []
    for r in run.requests:
        if r["end"] is not None:
            t = frames(r["audio_s"], fe)
            out += batch_sizes(t - run.mode.cal(t)[1], sv["batch_size"],
                               sv["group"])
    return out


class Program:
    """The port's model, built from the configuration's widths, and its
    request path."""

    def __init__(self, cfg, sd, device, tracer):
        from multipitch_architectures_tpu_torch.dsp import \
            compute_efficient_hcqt
        from multipitch_architectures_tpu_torch.experiments.configs import \
            build_model

        m = cfg["model"]
        with torch.device(device):
            net = build_model(m["class"], m["args"],
                              **{k: m[k] for k in ("attn_mode",) if k in m})
        net.load_state_dict(sd, strict=True)
        # buffers that the model computes (the positional table) too
        self.net = net.to(device).eval()
        self.hcqt = compute_efficient_hcqt
        self.mode = MODES[cfg["precision"]](cfg)
        module, name = self.mode.entry
        self.predict = getattr(importlib.import_module(module), name)
        self.cfg, self.device, self.tracer = cfg, device, tracer
        self.fe = cfg["frontend"]

    def forward(self, x):
        """The serving mode's call of the model on a recording's HCQT."""
        return self.predict(self.net, x, context=self.fe["context"],
                            batch_size=self.cfg["serve"]["batch_size"],
                            compression=self.fe["compression"],
                            group=self.cfg["serve"]["group"],
                            **self.mode.kwargs())

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
    """The reference in the program's place, in the precision below the
    configuration's (the serving mode's ``control``): what the output
    check has to reject."""

    def __init__(self, cfg, sd, device, tracer, root=common.ROOT):
        self.ref = common.reference(cfg, root).to(device).eval()
        self.ref.load_state_dict(sd)
        self.mode = MODES[cfg["precision"]](cfg)
        self.cfg, self.device, self.tracer = cfg, device, tracer
        self.fe = cfg["frontend"]

    def forward(self, x):
        return None

    def __call__(self, audio, request=None):
        h, p = self.mode.control(self.ref, audio, self.device)
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


def warm_up(prog, pool, cfg, device, mode):
    """Every batch size the pool's requests drain through, once, by the
    serving mode (``warm``), and the frontend on one second of the pool's
    first recording."""
    fe, sv = cfg["frontend"], cfg["serve"]
    sizes, lead = set(), 0
    for a in pool:
        t = frames(len(a) / fe["fs"], fe)
        served = mode.cal(t)[1]
        sizes.update(batch_sizes(t - served, sv["batch_size"], sv["group"]))
        lead = max(lead, served)
    sizes = sorted(sizes)
    x = torch.zeros((fe["num_harmonics"] + fe["num_subharmonics"], 1,
                     fe["bins_per_octave"] * fe["num_octaves"]),
                    device=device).expand(-1, lead + sizes[-1], -1)
    with torch.no_grad():
        if not isinstance(prog, Control):
            mode.warm(prog, x, lead, sizes)
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
        ref = common.reference(cfg, run.root)
    sd = weights.draw(ref, run.seed, dev, cfg["weights_law"])
    prog = (Control(cfg, sd, dev, run.tracer, run.root) if control
            else Program(cfg, sd, dev, run.tracer))
    run.mode = prog.mode
    run.warm_sizes = warm_up(prog, pool, cfg, dev, run.mode)
    return prog, pool, sd


def window(run, prog, pool):
    """The measured window: run.requests gets one dict per request."""
    mix, fe = run.mix, run.cfg["frontend"]
    from multipitch_architectures_tpu_torch.utils import counters

    reqs, outs = [], []
    before = dict(counters)
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
    run.counters = {k: v - before.get(k, 0) for k, v in counters.items()}
    run.requests = reqs
    return outs


def follow(run, prog, sd, pool, outs):
    """The serving mode's ``follow`` on one finished request drawn from
    the seed, while the program is held: None for the control, which
    has no stages of the program to follow."""
    done = [i for i, o in enumerate(outs) if o is not None]
    if isinstance(prog, Control) or not done:
        return None
    i = done[int(stream(run.seed, 6).integers(len(done)))]
    return run.mode.follow(run, prog, sd, pool[run.requests[i]["index"]],
                           outs[i][1])


def check(run, sd, pool, outs):
    """Run the reference over a sample of the finished requests, drawn
    from the seed with the longest in it, and return the compared numbers
    with their limits: the HCQT's error relative to its peak, and the
    serving mode's gaps of the predictions."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    done = [i for i, o in enumerate(outs) if o is not None]
    sample = mix["check"]
    by_len = sorted(done, key=lambda i: -run.requests[i]["audio_s"])
    picks = by_len[:sample["longest"]]
    rest = [i for i in done if i not in picks]
    rng = stream(run.seed, 5)
    picks += [rest[j] for j in rng.permutation(len(rest))[
        :sample["random"]]]
    ref = common.reference(cfg, run.root).to(dev).eval()
    ref.load_state_dict(sd)
    fe, mode = cfg["frontend"], run.mode
    worst = {"hcqt_rel": 0.0}
    with tf32(False):
        for i in picks:
            h = frontend.hcqt(pool[run.requests[i]["index"]], fe, dev)
            f, out = outs[i]
            hp = np.transpose(f, (2, 1, 0))
            gaps = mode.compare(ref, h, out) if hp.shape == h.shape \
                else None
            if gaps is None:
                return mode.numbers(collections.defaultdict(lambda: math.inf),
                                    len(picks), run)
            h = h.cpu().numpy()
            gaps["hcqt_rel"] = float(np.abs(hp - h).max() / np.abs(h).max())
            for k, v in gaps.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return mode.numbers(worst, len(picks), run)


def attempted(run):
    return len(run.requests)


def failed(run):
    return sum(r["end"] is None for r in run.requests)
