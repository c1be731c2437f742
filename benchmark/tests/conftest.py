"""Test settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the repository root on the path, the ``cuda`` marker
of tests that need the card (they skip without one, deciding inside the
test), and every other test with the harness pointed at the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _cpu_unless_cuda(request, monkeypatch):
    if request.node.get_closest_marker("cuda") is None:
        from portbench_tiny import cpu_harness
        cpu_harness(monkeypatch)
