"""The int8 serving mode's plain reference (``reference/quant.py``) and
its counts (``counts/int8.py``) against the program, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import common, weights
from portbench.counts import int8
from portbench.reference import quant

from .tiny import TINY_ARGS

SEED = 2 ** 31 + 41
MIN_ELEMS = 256


def tiny_cfg():
    cfg = common.load_json(os.path.join(common.ROOT, "portbench", "configs",
                                        "exp180e-int8.json"))
    cfg["model"]["args"].update(TINY_ARGS)
    cfg["model"]["attn_mode"] = "cross_batch:5"
    cfg["serve"] = {"batch_size": 10, "group": 5}
    cfg["quant"]["min_kernel_elems"] = MIN_ELEMS
    return cfg


@pytest.fixture(scope="module")
def models():
    """(configuration, the reference, the port's model), one set of
    weights from the seed."""
    from multipitch_architectures_tpu_torch import set_f32_parity
    from multipitch_architectures_tpu_torch.experiments.configs import \
        build_model

    set_f32_parity()
    torch.set_num_threads(2)
    cfg = tiny_cfg()
    ref = common.reference(cfg).eval()
    # the JAX package's int8 tests hold two programs to 5e-3 under flax's
    # default weights, the training law here; under the serving law's
    # He-uniform weights the bin flips cascade further (PERF.md, section 6)
    sd = weights.draw(ref, SEED, "cpu", "lecun_normal")
    ref.load_state_dict(sd)
    m = cfg["model"]
    net = build_model(m["class"], m["args"], attn_mode=m["attn_mode"])
    net.load_state_dict(sd)
    return cfg, ref, net.eval()


def hcqt(frames, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((6, frames, 216), generator=g) ** 4


def test_each_w8a8_conv_equals_the_ports_teacher_forced(models):
    """The port's ``Int8Conv2d`` and the reference's W8A8 conv, on the
    port's own input of each conv and the same scale: equal integer sums
    and equal float32 outputs."""
    from multipitch_architectures_tpu_torch.eval import quant as port
    from multipitch_architectures_tpu_torch.ops.int8_gemm import int8_conv2d

    cfg, ref, net = models
    x = torch.log1p(10 * hcqt(75 + 9))
    windows = torch.stack([x[:, i:i + 75] for i in range(10)])
    scales = port.calibrate_activation_scales(net, [windows], MIN_ELEMS)
    inputs = {}
    qnet = port.quantize_convs(net, MIN_ELEMS, scales)
    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: inputs.__setitem__(n, a[0].clone()))
        for n, m in qnet.named_modules() if isinstance(m, port.Int8Conv2d)]
    with torch.no_grad():
        qnet(windows)
    for h in hooks:
        h.remove()
    mods = dict(ref.named_modules())
    assert sorted(inputs) == sorted(n for n, _ in quant.eligible(
        ref, MIN_ELEMS))
    for name, xin in inputs.items():
        m, xs = mods[name], scales[name]
        with torch.no_grad():
            want = port.quantized_conv_static(xin, m.weight, m.bias,
                                              m.stride, m.padding, xs)
            got = quant.conv(m, xin, xs)
            ws = port._weight_scales(m.weight)
            sums = int8_conv2d(
                port._quantize(xin, xs).permute(0, 2, 3, 1).contiguous(),
                port._quantize(m.weight, ws[:, None, None, None]).permute(
                    0, 2, 3, 1).contiguous(), m.stride, m.padding)
            ref_ws = quant.weight_scales(m.weight)
            ref_sums = torch.nn.functional.conv2d(
                quant.quantize(xin, xs, quant.QMAX).double(),
                quant.quantize(m.weight, ref_ws[:, None, None, None],
                               quant.QMAX).double(),
                stride=m.stride, padding=m.padding)
        assert torch.equal(sums.permute(0, 3, 1, 2).double(), ref_sums), name
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)


def test_a_whole_request_agrees_to_bin_flips(models):
    """``predict_framewise_int8`` against the reference's transcription of
    the same HCQT: the calibration frames to float32 rounding, the int8
    frames within the JAX package's cross-program bound, and both apart
    from float32."""
    from multipitch_architectures_tpu_torch.eval import (
        predict_framewise, predict_framewise_int8)

    cfg, ref, net = models
    h = hcqt(37)
    sv, q = cfg["serve"], cfg["quant"]
    kw = dict(context=75, batch_size=sv["batch_size"], compression=10.0,
              group=sv["group"])
    with torch.no_grad():
        got = predict_framewise_int8(net, h, cal_batches=q["cal_batches"],
                                     min_kernel_elems=MIN_ELEMS, **kw)
        f32 = predict_framewise(net, h, **kw)
    cal, q8 = quant.transcribe(ref, h, 10.0, 75, sv["batch_size"],
                               sv["group"], q)
    n = cal.shape[0]
    assert n == 10 and q8.shape == (27, 72)
    torch.testing.assert_close(got[:n], cal, rtol=0, atol=1e-5)
    torch.testing.assert_close(got[n:], q8, rtol=0, atol=5e-3)
    assert (got[n:] - f32[n:]).abs().max() > 1e-4


def test_int8_counts_equal_the_quantized_references_convolutions(models):
    """At small widths: each W8A8 conv's operations equal what
    ``FlopCounterMode`` counts for it in the quantized reference's
    forward, whose whole count is the configuration's counts."""
    cfg, ref, _ = models
    x = torch.rand(5, 6, 75, 216)
    scales = {n: torch.tensor(0.01) for n, _ in quant.eligible(
        ref, MIN_ELEMS)}
    with quant.quantized(ref, scales, MIN_ELEMS), torch.no_grad(), \
            FlopCounterMode(display=False) as fc:
        ref(x)
    counted = fc.get_flop_counts()
    per_conv = [sum(counted[f"SAUnet.{n}"].values())
                for n, _ in quant.eligible(ref, MIN_ELEMS)]
    assert [c[0] * 5 for c in int8.convs(cfg)] == per_conv
    assert common.counts(cfg).forward_flops(cfg["model"]["args"], 5) == \
        fc.get_total_flops()


def test_int8_counts_at_exp180e_widths():
    """20.5 T int8 operations per fused batch of 250 over the 21 W8A8
    convs, 10.57 ms of least time at 1,979 TOP/s (bytes bound the head's
    three): PERF.md's kernel table."""
    cfg = common.load_json(os.path.join(common.ROOT, "portbench", "configs",
                                        "exp180e-int8.json"))
    costs = int8.convs(cfg)
    assert len(costs) == 21
    assert sum(c[0] for c in costs) * 250 == 20_510_297_424_000
    assert abs(int8.least_seconds(costs, 250) - 10.574e-3) < 1e-6


def test_weights_are_drawn_as_before():
    """The weights' rules, and the serving law's draw, of both earlier
    configurations are those the harness drew before configurations
    named their reference (digests taken then)."""
    import hashlib

    want = {
        ("exp180e-f32", "he_uniform"): "5c751560aa0c36f91fe7a98fe96c1730"
                                       "c44c69e699e8ca19f7d12145a569a41b",
        ("exp180e-f32", "lecun_normal"): "8c919fffe9ef9c9a25ab569f9bf98400"
                                         "54771c965204c78ab01883da585e5a1d",
        ("exp180d-f32", "he_uniform"): "30ff41e93a77d5c8b5cc7a28b97975a9"
                                       "7f546e792dd60c4b1e5cd6aa323c4b85",
        ("exp180d-f32", "lecun_normal"): "ee01da5192a1c439ab10412d4b99957e"
                                         "05dfee1c86637b37f9752a002cd17e80",
    }
    drawn = "4f3cbcb89d58012b3937c2b23e48808a6040e3e1dbeefd1a0e9043da917f85fc"
    for (name, law), digest in want.items():
        cfg = common.load_json(os.path.join(common.ROOT, "portbench",
                                            "configs", f"{name}.json"))
        with torch.device("meta"):
            ref = common.reference(cfg)
        rules = sorted((k, list(v)) for k, v in weights._rules(
            ref, law).items())
        assert hashlib.sha256(json.dumps(rules).encode()).hexdigest() == \
            digest, (name, law)
        if name == "exp180e-f32" and law == cfg["weights_law"]:
            sd = weights.draw(ref, 2 ** 31 + 11, "cpu", law)
            h = hashlib.sha256()
            for k in sorted(sd):
                h.update(k.encode())
                h.update(sd[k].contiguous().numpy().tobytes())
            assert h.hexdigest() == drawn


def test_lstm_weights_follow_pytorchs_default():
    lstm = torch.nn.Module()
    lstm.rnn = torch.nn.LSTM(8, 16, bidirectional=True, batch_first=True)
    for law, bias in (("he_uniform", ("uniform", 0.25)),
                      ("lecun_normal", ("const", 0.0))):
        rules = weights._rules(lstm, law)
        assert rules["rnn.weight_hh_l0_reverse"] == ("uniform", 0.25)
        assert rules["rnn.bias_ih_l0"] == bias
        sd = weights.draw(lstm, 5, "cpu", law)
        assert np.abs(sd["rnn.weight_ih_l0"].numpy()).max() <= 0.25
