"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed, the program built and every
shape of the cell's traffic warmed up) counts into ``setup_s``; then the
window runs for ``--seconds``; then the peak memory is read, the
program's state freed, and the plain reference checks the window's
outputs. The compared numbers and their limits are the last lines on
standard error and the last key of the result line.
"""

import argparse
import json
import math
import os
import sys
import time

from . import common


class Run:
    """What one run records, for the metric readers."""

    def __init__(self, cell, cfg, mix, seed, seconds, trace, device,
                 start, root=common.ROOT):
        from .trace import Tracer

        self.cell, self.cfg, self.mix, self.root = cell, cfg, mix, root
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.start = device, start
        self.tracer = Tracer(trace, device)
        self.requests = []
        self.steps = 0
        self.windows_per_step = None
        self.window_start = self.window_end = None
        self.model_ms = None
        self.followed = None

    @property
    def spans(self):
        return self.tracer.spans

    @property
    def profile(self):
        return self.tracer.summary

    @property
    def setup_s(self):
        return self.window_start - self.start


def cell_files(name, root):
    bench = common.benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = common.load_json(os.path.join(root, conf["file"]))
    mix = common.traffic_file(cell["traffic"], root)
    return bench, cell, cfg, mix


def metrics_of(bench, cell, trace):
    """The cell's metric entries: end to end, or per layer."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if cell["name"] in m.get("workloads", [cell["name"]])]


def model_timer(net):
    """CUDA events around each forward of ``net`` (its top module)."""
    import torch

    pairs = []

    def pre(module, args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        pairs.append([e, None])

    def post(module, args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        pairs[-1][1] = e

    hooks = [net.register_forward_pre_hook(pre),
             net.register_forward_hook(post)]
    return pairs, hooks


def run_cell(name, seed, seconds, trace, root=common.ROOT, start=None,
             require_card=True, control=False, overrides=None):
    """One run: (result dict, its ``Run``). ``require_card=False`` runs
    on the CPU (the tests); ``control=True`` puts the reference, computed
    in the precision below the configuration's, in the program's place;
    ``overrides`` replace keys of the traffic mix (the rate sweep)."""
    start = time.perf_counter() if start is None else start
    import torch

    bench, cell, cfg, mix = cell_files(name, root)
    mix = {**mix, **(overrides or {})}
    if require_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{cell['name']} needs {cell['chips']} CUDA "
                             f"device(s); found "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    from multipitch_architectures_tpu_torch import set_f32_parity

    if mix["kind"] == "serve":
        from . import serve as kind

        precisions = kind.MODES
    elif mix["kind"] == "train":
        from . import train as kind

        precisions = ("float32",)
    else:
        raise SystemExit(f"unknown traffic kind {mix['kind']!r}")
    if cfg["precision"] not in precisions:
        raise SystemExit(f"unsupported precision {cfg['precision']!r} for "
                         f"{mix['kind']!r} traffic")
    # float32 with TF32 off in every mode: an int8 model's float32 rest too
    set_f32_parity()
    cuda = device.type == "cuda"
    run = Run(cell, cfg, mix, seed, seconds, bool(trace), device, start,
              root)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    if mix["kind"] == "serve":
        prog, pool, sd = kind.setup(run, control)
        hooks = []
        if trace and cuda and not control:
            pairs, hooks = model_timer(prog.net)
        outs = kind.window(run, prog, pool)
        for h in hooks:
            h.remove()
        if hooks:
            torch.cuda.synchronize()
            run.model_ms = [a.elapsed_time(b) for a, b in pairs]
        state = (sd, pool, outs)
    else:
        sd, files, readings = kind.setup_and_window(run, control)
        prog = None
        state = (sd, files, readings)

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.tracer.reduce()
    values = {}
    for m in metrics_of(bench, cell, trace):
        v = common.metric_reader(m["name"], root)(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and run.profile is not None:
        device_info["busy_s"] = run.profile["busy_s"]
        device_info["window_s"] = run.profile["window_s"]
        breakdown = {"device_ops": run.profile["device_ops"],
                     "idle_gaps": run.profile["idle_gaps"]}
    attempted, failed = kind.attempted(run), kind.failed(run)
    if mix["kind"] == "serve":
        # one request served again and followed stage by stage, while the
        # program is held
        run.followed = kind.follow(run, prog, *state)

    # the program's state goes before the reference runs
    if prog is not None:
        prog.free()
    if getattr(run, "trainer", None) is not None:
        del run.trainer
    if cuda:
        torch.cuda.empty_cache()
    numbers = kind.check(run, *state)
    correct = all(lim is None or (not math.isnan(v) and v <= lim)
                  for v, lim in numbers.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result, run


def main(argv=None, start=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, run = run_cell(args.workload, args.seed, args.seconds,
                           args.trace, start=start)
    found = common.forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    if run.requests and run.mix.get("loop") == "open":
        from . import reduce

        lat = reduce.latencies_ms(run)
        print(f"request latency: median {reduce.percentile(lat, 50)} ms, "
              f"p90 {reduce.percentile(lat, 90)} ms over {len(lat)} "
              f"requests", file=sys.stderr)
    for m, v in result["metrics"].items():
        print(f"{m}: {v['value']} {v['unit']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
