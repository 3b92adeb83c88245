"""The readings that the output check's limits are set from, several
seeds in one process: the program's (``--mode program``), the control's
(the reference in TF32 in the program's place, ``--mode control``) and
those of a planted fault (``--mode`` a name of ``faults.planted``, from
the trainer's step ``--after`` on).
Also the rate sweep of an open-loop mix (``--rate``).

    python -m portbench.readings --workload exp180e-f32.clips \\
        --seeds 1,2,3 --seconds 20 --mode control

One JSON line per seed on standard output. The benchmark's own runs do
not run this.
"""

import argparse
import json
import math
import time

from . import faults, reduce
from .run import run_cell


def summary(run):
    """Latency quartiles and the backlog of an open loop's window."""
    reqs = run.requests
    if not reqs or reqs[0]["due"] is None:
        return {}
    lat = reduce.latencies_ms(run)
    late = [r for r in reqs if r["start"] is None
            or r["start"] > run.seconds]
    waits = [(r["start"] - r["due"]) for r in reqs if r["start"] is not None]
    third = max(1, len(waits) // 3)
    return {"n": len(lat), "p50_ms": reduce.percentile(lat, 50),
            "p90_ms": reduce.percentile(lat, 90),
            "backlog_at_close": len(late),
            "wait_first_third_s": sum(waits[:third]) / third,
            "wait_last_third_s": sum(waits[-third:]) / third,
            "service_mean_s": sum(r["end"] - r["start"] for r in reqs
                                  if r["end"] is not None) / len(waits)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--after", type=int, default=0,
                    help="a training fault begins at this step")
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    overrides = {} if args.rate is None else {"rate_per_s": args.rate}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with faults.planted(None if args.mode in ("program", "control")
                            else args.mode, args.after):
            result, run = run_cell(args.workload, seed, args.seconds,
                                   args.trace, control=args.mode == "control",
                                   overrides=overrides)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "mode": args.mode,
            "rate": args.rate, "after": args.after, "correct": result["correct"],
            "checks": {k: v["value"] for k, v in result["checks"].items()},
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "attempted": result["attempted"], "failed": result["failed"],
            "peak_gib": result["device"]["memory_peak_bytes"] / 2 ** 30,
            "open_loop": summary(run),
            "wall_s": time.perf_counter() - t0},
            default=lambda x: None if isinstance(x, float) and math.isinf(x)
            else str(x)), flush=True)


if __name__ == "__main__":
    main()
