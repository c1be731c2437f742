"""``correct`` comes out false when the timed path is broken underneath.

Each test drives the rest of a run of a cell at the tiny CPU size
(``portbench_tiny``; the look for a card is skipped), with one fault
planted in the program: an answer altered where it is produced, half
of the batch left out, a step that leaves its state unchanged.  The
sound run of each cell comes out correct, and the fp8 control (the
reference put in the program's place) fails one of the cell's numbers.
One chip only: no exchange between chips to leave out.
"""

import pytest

from benchmark import common, faults
from portbench_tiny import tiny_cell

CELLS = ["serve_ct320x24_s075", "pretrain_mv_b14", "tune_downstream_b16",
         "serve_ct512x64_s050"]


def _run(workload):
    cell = tiny_cell(workload)
    return cell, common.driver(cell).run(cell)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    _, out = _run(workload)
    assert out.correct, out.checks


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    cell = tiny_cell(workload)
    got = common.driver(cell).control(cell)
    got = got if isinstance(got, dict) else {"prob_gap": got}
    limits = cell.traffic["limits"]
    assert any(v > limits[k] for k, v in got.items()), (got, limits)


@pytest.fixture
def planted():
    undo = []
    yield lambda name: undo.append(faults.plant(name))
    for u in undo:
        u()


@pytest.mark.parametrize("fault", faults.SERVING)
@pytest.mark.parametrize("workload", ["serve_ct320x24_s075",
                                      "serve_ct512x64_s050"])
def test_serving_faults(planted, workload, fault):
    planted(fault)
    _, out = _run(workload)
    assert not out.correct, out.checks


@pytest.mark.parametrize("fault", faults.TRAINING)
@pytest.mark.parametrize("workload", ["pretrain_mv_b14",
                                      "tune_downstream_b16"])
def test_training_faults(planted, workload, fault):
    planted(fault)
    _, out = _run(workload)
    assert not out.correct, out.checks
