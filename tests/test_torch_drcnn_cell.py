"""The training cell ``exp128c-f32.train`` run whole through the
benchmark's harness on the CPU at tiny widths (its look for a card
skipped): a sound run reads ``correct``, and a run with the timed path
broken underneath reads ``correct`` false. The faults: the harness's own
training faults (a step that leaves the state unchanged, a step on half
of the batch), and three of DRCNN's own, planted in the port's model as
the harness builds it: the residual shortcuts dropped, dropout off, and
one prefilter block's weights altered by 1e-3 relative."""

import os

import pytest
import torch
from torch import nn

import multipitch_architectures_tpu_torch.experiments.configs as port_configs
from portbench.common import load_json, traffic_file
from portbench.faults import planted
from portbench.run import run_cell
from portbench.tests.tiny import make_root, write

CELL = "exp128c-f32.train"
SEED = 2 ** 31 + 1907
SETUP_STEPS = traffic_file("train")["setup_steps"]
# the prefilter four channels wide (the head 8, 6, 4) and a batch of 2:
# the CPU's backward of a 15x15 conv at 75 x 216 is what a run costs
TINY = {"n_chan_layers": [4, 8, 6, 4], "n_prefilt_layers": 3}
# the window closes at the first batch asked for after it: one step
ONE_STEP = 0.01


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One tiny benchmark root for the module, whose DRCNN keeps the
    published bins and shortcuts at tiny widths and three prefilter
    blocks."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    root = make_root(str(tmp_path_factory.mktemp("bench")))
    path = os.path.join(root, "portbench", "configs", "exp128c-f32.json")
    cfg = load_json(path)
    published = load_json(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench", "configs",
        "exp128c-f32.json"))
    cfg["model"]["args"] = {**published["model"]["args"], **TINY}
    cfg["train"]["batch_size"] = 2
    write(path, cfg)
    yield root
    torch.set_num_threads(before)


def run(root, trace=0, seconds=ONE_STEP):
    return run_cell(CELL, SEED, seconds, trace, root=root,
                    require_card=False)


def test_a_sound_run_is_correct(root):
    result, r = run(root, trace=1, seconds=1.0)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_mfu.train"}
    assert r.cfg["model"]["args"]["residual"] is True
    untraced, _ = run(root)
    assert set(untraced["metrics"]) == {"train_windows_per_s", "setup_s"}


@pytest.mark.parametrize("fault,after", [("frozen_step", 0),
                                         ("half_batch", 0),
                                         ("frozen_step", SETUP_STEPS),
                                         ("half_batch", SETUP_STEPS)])
def test_the_harness_training_faults_are_caught(root, fault, after):
    with planted(fault, after):
        result, _ = run(root)
    assert not result["correct"], result["checks"]


def no_shortcut(net):
    net.residual = False


def no_dropout(net):
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0


def altered_prefilter(net):
    def alter(module, keys):
        with torch.no_grad():
            module.prefilt_list[0][0].weight.mul_(1.0 + 1e-3)
    net.register_load_state_dict_post_hook(alter)


@pytest.mark.parametrize("fault", [no_shortcut, no_dropout,
                                   altered_prefilter])
def test_drcnn_faults_are_caught(root, monkeypatch, fault):
    real = port_configs.build_model

    def build(*args, **kwargs):
        net = real(*args, **kwargs)
        fault(net)
        return net
    monkeypatch.setattr(port_configs, "build_model", build)
    result, _ = run(root)
    assert not result["correct"], result["checks"]
