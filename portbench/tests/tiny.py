"""A benchmark root with the real cells' files cut to a size that the
CPU runs in seconds: the same code, tiny widths, short traffic."""

import json
import os
import shutil

from portbench.common import ROOT, load_json

TINY_ARGS = {"embed_dim": 32, "mlp_dim": 64, "n_chan_layers": [8, 6, 5, 4],
             "scalefac": 16}


def make_root(tmp, seconds_law=(1.0, 1.6)):
    """A copy of BENCHMARK.json and portbench's data files under ``tmp``,
    each configuration at tiny widths and each mix short."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for sub in ("metrics", "traffic", "configs", "reference", "counts"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        os.path.join(tmp, "portbench", sub))
    for c in bench["configs"]:
        path = os.path.join(tmp, c["file"])
        cfg = load_json(path)
        cfg["model"]["args"].update(TINY_ARGS)
        if "serve" in cfg:
            cfg["serve"] = {"batch_size": 10, "group": 5}
            cfg["model"]["attn_mode"] = "cross_batch:5"
        if "quant" in cfg:
            # 20 of the tiny model's 22 convs W8A8 (15 at 4096); limits
            # for this size alone: sound runs read int8_pred_abs ~0.05 and
            # int8_pred_mean_abs ~7e-3, weights at 4 bits 0.29 and 0.035,
            # the 4-bit control 0.39 and 0.083
            cfg["quant"]["min_kernel_elems"] = 256
            cfg["limits"].update(int8_pred_abs=0.2, int8_pred_mean_abs=0.02)
        if "train" in cfg:
            cfg["train"]["batch_size"] = 4
            # the tiny model's later steps part by Adam's round-off more
            # than the full widths' do: limits for this size alone
            cfg["limits"] = {"loss1_rel": 1e-5, "grad_norm_gap": 1e-4,
                             "change_norm_gap": 0.3, "window_loss_rel": 1e-5,
                             "window_grad_gap": 1e-2,
                             "window_change_gap": 0.3}
        write(path, cfg)
    tdir = os.path.join(tmp, "portbench", "traffic")
    for name in ("corpus", "corpus-fixed", "clips"):
        mix = load_json(os.path.join(tdir, f"{name}.json"))
        mix["length_s"] = {"law": "log_uniform", "low": seconds_law[0],
                           "high": seconds_law[1]}
        mix["check"] = {"longest": 1, "random": 1}
        if mix["loop"] == "closed":
            mix["pool"] = 3
        else:
            mix["rate_per_s"] = 1.0
        write(os.path.join(tdir, f"{name}.json"), mix)
    mix = load_json(os.path.join(tdir, "train.json"))
    mix["corpus"] = {"files": 2, "length_frames": {
        "law": "log_uniform", "low": 400, "high": 500}}
    mix["profile_skip"], mix["profile_steps"] = 1, 2
    write(os.path.join(tdir, "train.json"), mix)
    write(os.path.join(tmp, "BENCHMARK.json"), bench)
    return tmp


def count_cpu_launches(monkeypatch):
    """Each call of the int8 GEMM's plain version, the fused entry's CPU
    implementation, counted as the card's kernel counts its launches:
    the int8 cell's check reads the counter."""
    from multipitch_architectures_tpu_torch.ops import int8_gemm
    from multipitch_architectures_tpu_torch.utils import counters

    real = int8_gemm.int8_conv2d_dequant_reference

    def counted(*args, **kwargs):
        counters["int8.conv_dequant_launches"] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(int8_gemm, "int8_conv2d_dequant_reference", counted)


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
