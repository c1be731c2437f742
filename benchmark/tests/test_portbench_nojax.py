"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the program.  Module names are compared by
their whole top-level name (the part before the first dot): the
program's name begins with the JAX package's."""

import json
import subprocess
import sys

from benchmark import common

PORT = "medical_image_segmentation_with_visual_prompts_tpu_torch"

ALL = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import benchmark, benchmark.arith, benchmark.common, benchmark.generate
import benchmark.training, benchmark.calibrate, benchmark.run
import benchmark.reference.model, benchmark.reference.serve
import benchmark.reference.train
import pytest
from benchmark import common
from portbench_tiny import cpu_harness, tiny_cell
cpu_harness(pytest.MonkeyPatch())
man = common.load_manifest()
for w in man["workloads"]:
    common.per_layer_readers(man, w["name"])
for w in ("serve_ct320x24_s075", "tune_downstream_b16", "pretrain_mv_b14"):
    cell = tiny_cell(w, seconds=0.05)
    common.driver(cell).run(cell)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.model, benchmark.reference.serve
import benchmark.reference.train
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(
            root=str(common.ROOT), tests=str(common.BENCH / "tests"))],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compared_whole():
    assert PORT.startswith(common.FORBIDDEN[-1])
    assert PORT not in common.FORBIDDEN


def test_benchmark_loads_no_jax():
    tops = _tops(ALL)
    assert PORT in tops          # the runs did drive the program
    assert not tops & set(common.FORBIDDEN), tops & set(common.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE)
    assert PORT not in tops
    assert not tops & set(common.FORBIDDEN)
