"""On the card: the control, the plain reference put in the program's
place and computed in the precision below the configuration's (TF32 for
float32, 4 bits for int8), reads ``correct`` false in every cell, at
the cells' own widths and loads over a short window. ``python -m pytest
portbench/tests -q -m card`` on a machine with an H100."""

import pytest

from portbench.run import run_cell


@pytest.mark.card
@pytest.mark.parametrize("cell,seconds", [("exp180e-f32.corpus", 8.0),
                                          ("exp180e-f32.clips", 10.0),
                                          ("exp180d-f32.train", 2.0),
                                          ("exp180e-int8.corpus", 8.0)])
def test_the_control_is_not_correct(card, cell, seconds):
    result, _ = run_cell(cell, 2 ** 31 + 3, seconds, 0, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.card
def test_a_sound_run_is_correct(card):
    result, _ = run_cell("exp180e-f32.clips", 2 ** 31 + 4, 10.0, 0)
    assert result["correct"], result["checks"]
