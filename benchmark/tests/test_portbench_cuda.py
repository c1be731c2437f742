"""On the card, at each cell's own size: the fp8 control (the reference
put in the program's place) fails one of the cell's compared numbers on
three seeds, and a short sound run of the program is correct.  Skips
without a CUDA card (decided inside each test).

    python -m pytest -m cuda benchmark/tests/test_portbench_cuda.py
"""

import pytest
import torch

from benchmark import common

CELLS = [w["name"] for w in common.load_manifest()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_card(workload):
    _card()
    manifest = common.load_manifest()
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        cell = common.load_cell(manifest, workload, seed, 2.0, False)
        got = common.driver(cell).control(cell)
        got = got if isinstance(got, dict) else {"prob_gap": got}
        limits = cell.traffic["limits"]
        assert any(v > limits[k] for k, v in got.items()), (seed, got)
        common.free_memory()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_on_card(workload):
    _card()
    manifest = common.load_manifest()
    cell = common.load_cell(manifest, workload, 2 ** 31 + 201, 2.0, False)
    out = common.driver(cell).run(cell)
    assert out.correct, out.checks
    common.free_memory()
