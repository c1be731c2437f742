"""A traced run (``--trace 1``) of each cell at the tiny CPU size goes
through its three passes and builds the result line: the per-layer
metrics that find something to read, ``device`` with ``busy_s`` and
``window_s``, the ``breakdown``, and the compared numbers last."""

import pytest

from benchmark import common
from benchmark import run as bench_run
from portbench_tiny import tiny_cell

CELLS = [w["name"] for w in common.load_manifest()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_builds_its_line(workload):
    cell = tiny_cell(workload, trace=True)
    out = common.driver(cell).run(cell)
    assert out.correct, out.checks
    ctx = out.ctx
    assert ctx["units"] == int(cell.traffic["trace_units"])
    assert ctx["plain_window_s"] > 0
    line = bench_run.result(cell, common.load_manifest(), out, 1.0)
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"busy_s", "window_s",
                                   "memory_peak_bytes"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    allowed = {m["name"] for m in common.load_manifest()["per_layer"]
               if workload in m["workloads"]}
    assert set(line["metrics"]) <= allowed
