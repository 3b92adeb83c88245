"""A run with its timed path broken underneath reads ``correct`` false:
for a serving cell, an answer altered where it is produced; for the
training cell, a step that leaves its state unchanged and a step on half
of the batch, each from the first step on and from the first step after
set-up on (inside the window alone). The harness runs on the CPU at tiny
widths here, its look for a card skipped; everything after that is a
whole run."""

import pytest

from portbench.common import traffic_file
from portbench.faults import planted
from portbench.run import run_cell

SEED = 2 ** 31 + 77
SETUP_STEPS = traffic_file("train")["setup_steps"]


def run(root, cell, trace=0):
    return run_cell(cell, SEED, 1.0, trace, root=root, require_card=False)[0]


@pytest.mark.parametrize("cell", ["exp180e-f32.corpus", "exp180e-f32.clips",
                                  "exp180d-f32.train", "exp180e-int8.corpus"])
def test_sound_runs_are_correct(tiny_root, cell):
    result = run(tiny_root, cell, trace=1)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault,after", [
    ("exp180e-f32.corpus", "altered_answer", 0),
    ("exp180e-f32.clips", "altered_answer", 0),
    ("exp180d-f32.train", "frozen_step", 0),
    ("exp180d-f32.train", "half_batch", 0),
    ("exp180d-f32.train", "frozen_step", SETUP_STEPS),
    ("exp180d-f32.train", "half_batch", SETUP_STEPS),
    ("exp180e-int8.corpus", "altered_answer", 0),
    ("exp180e-int8.corpus", "weights_4bit", 0),
    ("exp180e-int8.corpus", "first_scales_reused", 0),
    ("exp180e-int8.corpus", "dynamic_scales", 0),
    ("exp180e-int8.corpus", "float32_served", 0)])
def test_a_planted_fault_is_caught(tiny_root, cell, fault, after):
    with planted(fault, after):
        result = run(tiny_root, cell)
    assert not result["correct"], result["checks"]


def test_the_int8_control_is_not_correct(tiny_root):
    """The reference at 4 bits in the program's place."""
    result = run_cell("exp180e-int8.corpus", SEED, 1.0, 0, root=tiny_root,
                      require_card=False, control=True)[0]
    assert not result["correct"], result["checks"]
    # by the output's gaps, not only by the stages it has none of
    c = result["checks"]["int8_pred_mean_abs"]
    assert c["value"] > c["limit"]
