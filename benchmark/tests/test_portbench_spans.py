"""The program's tracer (``utils/trace.py`` of the port) stays off
through a run: an untraced run (``--trace 0``) of each cell at the tiny
CPU size leaves it disabled, with nothing recorded, so the end-to-end
metrics measure the program as it is deployed."""

import pytest

from benchmark import common
from portbench_tiny import tiny_cell

CELLS = [w["name"] for w in common.load_manifest()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_leaves_the_tracer_off(workload):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import trace
    cell = tiny_cell(workload)
    out = common.driver(cell).run(cell)
    assert out.correct, out.checks
    assert not trace.enabled()
    assert trace.collect() == {"spans": [], "counters": {}}
