"""Configurations arrive as files: a model of another family, with its
plain reference and counts, and the int8 serving precision run through
``run_cell`` on the CPU in a copy of the benchmark, with no harness file
changed."""

import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import common, reduce, serve
from portbench.counts import int8
from portbench.run import run_cell

from .tiny import write

# a plain reference of the port's ``basic_cnn`` (one 75-frame window to
# one frame: a 15x15 conv and a (2, 1) max-pool, a 3x3 conv of stride 3
# and a (2, 1) max-pool, a (6, 1) conv, a 1x1 conv and the last conv),
# with the reference's parameter names
REFERENCE = '''
import torch
from torch import nn


class BasicCnn(nn.Module):
    def __init__(self, n_chan_input, n_chan_layers, n_bins_in, n_bins_out,
                 a_lrelu):
        super().__init__()
        c = n_chan_layers
        self.layernorm = nn.LayerNorm([n_chan_input, n_bins_in])

        def block(c_in, c_out, k, stride=1, padding=0, pool=None):
            layers = [nn.Conv2d(c_in, c_out, k, stride, padding),
                      nn.LeakyReLU(a_lrelu)]
            if pool:
                layers.append(nn.MaxPool2d(pool))
            return nn.Sequential(*layers, nn.Dropout())

        self.conv1 = block(n_chan_input, c[0], 15, padding=7, pool=(2, 1))
        self.conv2 = block(c[0], c[1], 3, stride=3, pool=(2, 1))
        self.conv3 = block(c[1], c[2], (6, 1))
        self.conv4 = nn.Sequential(
            nn.Conv2d(c[2], c[3], 1), nn.LeakyReLU(a_lrelu), nn.Dropout(),
            nn.Conv2d(c[3], 1, (1, n_bins_in // 3 + 1 - n_bins_out)),
            nn.Sigmoid())

    def forward(self, x):
        x = self.layernorm(x.transpose(1, 2)).transpose(1, 2)
        return self.conv4(self.conv3(self.conv2(self.conv1(x))))


def build(model_cfg):
    a = model_cfg["args"]
    return BasicCnn(a["n_chan_input"], a["n_chan_layers"], a["n_bins_in"],
                    a["n_bins_out"], a["a_lrelu"])
'''

COUNTS = '''
def _conv(b, c_in, c_out, kh, kw, ho, wo):
    return 2 * b * c_in * c_out * kh * kw * ho * wo


def forward_flops(args, batch, group=None, context=75):
    c, f = args["n_chan_layers"], args["n_bins_in"]
    t2, f2 = (context // 2 - 3) // 3 + 1, (f - 3) // 3 + 1
    return (_conv(batch, args["n_chan_input"], c[0], 15, 15, context, f)
            + _conv(batch, c[0], c[1], 3, 3, t2, f2)
            + _conv(batch, c[1], c[2], 6, 1, 1, f2)
            + _conv(batch, c[2], c[3], 1, 1, 1, f2)
            + _conv(batch, c[3], 1, 1, f2 - args["n_bins_out"] + 1, 1,
                    args["n_bins_out"]))
'''


def add_cell(root, config, cfg, cell, traffic, metrics):
    """The configuration's file and its BENCHMARK.json entries; the cell
    joins the ``metrics``' workloads."""
    bench = common.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": config, "source": "x", "reduced": [],
                             "file": f"portbench/configs/{config}.json",
                             "why": "x"})
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(cell)
    write(os.path.join(root, "portbench", "configs", f"{config}.json"), cfg)
    write(os.path.join(root, "BENCHMARK.json"), bench)


def test_a_model_of_another_family_arrives_as_files(tiny_root):
    root, pb = tiny_root, os.path.join(tiny_root, "portbench")
    for kind, text in (("reference", REFERENCE), ("counts", COUNTS)):
        with open(os.path.join(pb, kind, "tiny_cnn.py"), "w") as f:
            f.write(text)
    cfg = common.load_json(os.path.join(pb, "configs", "exp180e-f32.json"))
    cfg.update(name="cnn-f32", reference="tiny_cnn", counts="tiny_cnn",
               model={"class": "basic_cnn", "args": {
                   "n_chan_input": 6, "n_chan_layers": [4, 5, 3, 2],
                   "n_bins_in": 216, "n_bins_out": 72, "a_lrelu": 0.3,
                   "p_dropout": 0.2}})
    add_cell(root, "cnn-f32", cfg, "cnn-f32.corpus", "corpus",
             ("audio_rt", "serve_mfu.corpus"))
    result, run = run_cell("cnn-f32.corpus", 2 ** 31 + 19, 1.0, 1, root=root,
                           require_card=False)
    assert result["correct"], result["checks"]
    assert result["checks"]["pred_abs"]["value"] > 0
    # the harness counted the model's work with the configuration's counts
    ref = common.reference(cfg, root)
    with FlopCounterMode(display=False) as fc:
        ref(torch.zeros(5, 6, 75, 216))
    assert common.counts(cfg, root).forward_flops(
        cfg["model"]["args"], 5) == fc.get_total_flops()
    want = 100.0 * fc.get_total_flops() / 5 * reduce.windows(run) \
        / run.window_end / common.FLOAT32_PEAK
    assert abs(result["metrics"]["serve_mfu.corpus"]["value"] / want - 1) \
        < 1e-12
    e2e, _ = run_cell("cnn-f32.corpus", 2 ** 31 + 19, 1.0, 0, root=root,
                      require_card=False)
    assert set(e2e["metrics"]) == {"audio_rt", "setup_s"}


def test_the_int8_precision_arrives_as_a_file(tiny_root):
    """A second int8 configuration, the tiny exp180e-int8's widths
    changed, added as a file beside it."""
    root, pb = tiny_root, os.path.join(tiny_root, "portbench")
    cfg = common.load_json(os.path.join(pb, "configs", "exp180e-int8.json"))
    cfg["name"] = "exp180e-int8-wide"
    cfg["model"]["args"]["n_chan_layers"] = [8, 7, 6, 5]
    add_cell(root, "exp180e-int8-wide", cfg, "exp180e-int8-wide.corpus",
             "corpus", ("audio_rt.int8", "serve_mfu.int8"))
    result, run = run_cell("exp180e-int8-wide.corpus", 2 ** 31 + 23, 1.0, 0,
                           root=root, require_card=False)
    assert result["correct"], result["checks"]
    checks = result["checks"]
    assert set(checks) == {"hcqt_rel", "cal_pred_abs", "int8_pred_abs",
                           "int8_pred_mean_abs", "int8_conv_count_gap",
                           "int8_scale_rel", "int8_conv_sum_gap",
                           "int8_stage_rel", "int8_answer_abs",
                           "replay_pred_abs", "requests_compared"}
    assert checks["int8_pred_mean_abs"]["value"] > 0
    # every W8A8 conv of the followed batch equal to the reference's
    assert checks["int8_conv_sum_gap"]["value"] == 0
    assert checks["int8_conv_count_gap"]["value"] == 0
    assert set(result["metrics"]) == {"audio_rt.int8", "setup_s"}
    traced, run = run_cell("exp180e-int8-wide.corpus", 2 ** 31 + 23, 1.0, 1,
                           root=root, require_card=False)
    # the int8 operations weighed at the float32 peak over the int8 one
    flops = reduce.serve_flops_per_window(run)
    ops = sum(c[0] for c in int8.convs(run.cfg, root))
    assert 0 < reduce.serve_flops(run) < flops * reduce.windows(run)
    assert run.mode.window_flops(run, flops) == pytest.approx(
        flops - ops * (1 - common.FLOAT32_PEAK
                       / common.PEAKS["int8_op_per_s"]))
    assert set(traced["metrics"]) == {"serve_mfu.int8"}
    # the int8 GEMM's roofline from one second of its kernels' device time
    run.tracer.summary = {"kernels_s": {"int8_gemm_kernel<128>": 0.5,
                                        "int8_gemm_kernel<64>": 0.5}}
    sizes = serve.served_batches(run)
    assert len(sizes) >= len(run.requests)
    assert reduce.int8_gemm_roofline(run) == pytest.approx(100.0 * sum(
        int8.least_seconds(int8.convs(run.cfg, root), b) for b in sizes))
