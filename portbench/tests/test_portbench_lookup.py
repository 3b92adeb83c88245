"""A configuration, a traffic mix and a per-layer metric added as new
files, with their BENCHMARK.json entries, are found by name: no file of
the harness changes."""

import json
import os
import subprocess
import sys

from portbench.common import ROOT
from portbench.run import run_cell

from .tiny import write


def test_new_files_are_found_by_name(tiny_root):
    root = tiny_root
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "exp180e-f32.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "exp180e-wide"
    cfg["model"]["args"]["n_chan_layers"] = [8, 7, 6, 5]
    write(os.path.join(pb, "configs", "exp180e-wide.json"), cfg)
    with open(os.path.join(pb, "traffic", "clips.json")) as f:
        mix = json.load(f)
    mix["rate_per_s"] = 1.5
    mix["length_s"] = {"law": "log_uniform", "low": 1.2, "high": 1.8}
    write(os.path.join(pb, "traffic", "busy.json"), mix)
    with open(os.path.join(pb, "metrics", "requests_served.busy.py"),
              "w") as f:
        f.write("def read(run):\n    return float(len(run.requests))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "exp180e-wide", "source": "x",
                             "file": "portbench/configs/exp180e-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "exp180e-wide.busy",
                               "config": "exp180e-wide",
                               "traffic": "busy", "chips": 1, "why": "x"})
    bench["end_to_end"][1]["workloads"].append("exp180e-wide.busy")
    bench["per_layer"].append({"name": "requests_served.busy",
                               "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "request",
                               "moves": "request_p90_ms",
                               "workloads": ["exp180e-wide.busy"]})
    write(os.path.join(root, "BENCHMARK.json"), bench)
    result, run = run_cell("exp180e-wide.busy", 3, 2.0, 1, root=root,
                           require_card=False)
    assert result["correct"], result["checks"]
    assert result["metrics"]["requests_served.busy"]["value"] == 3.0
    e2e, _ = run_cell("exp180e-wide.busy", 3, 2.0, 0, root=root,
                      require_card=False)
    assert set(e2e["metrics"]) == {"request_p90_ms", "setup_s"}


def test_a_metric_without_a_file_reads_with_its_familys(tmp_path):
    """``k1_roofline.int8`` has no file of its own: it reads with
    ``k1_roofline.py``; a file of the metric's own name comes first."""
    from portbench.common import metric_reader

    d = tmp_path / "portbench" / "metrics"
    d.mkdir(parents=True)
    (d / "k1_roofline.py").write_text("def read(run):\n    return 1.0\n")
    (d / "k1_roofline.clips.py").write_text(
        "def read(run):\n    return 2.0\n")
    root = str(tmp_path)
    assert metric_reader("k1_roofline.int8", root)(None) == 1.0
    assert metric_reader("k1_roofline.int8.long", root)(None) == 1.0
    assert metric_reader("k1_roofline.clips", root)(None) == 2.0
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(m["name"]))


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "exp180e-f32.corpus", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
