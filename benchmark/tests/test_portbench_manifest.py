"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return common.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(manifest, section, keys):
    names = [e["name"] for e in manifest[section]]
    assert len(names) == len(set(names))
    for e in manifest[section]:
        assert set(e) == keys
        assert NAME.match(e["name"])
        assert TEXT.match(e["why"])


def test_configs_load_by_name(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert TEXT.match(c["source"]) and c["source"].startswith("https://")
        conf = json.loads((common.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert set(c["reduced"]) == set(conf["changed_from_source"])
        hp = conf["hparams"]
        for key, change in conf["changed_from_source"].items():
            assert hp[key] == change["run"]
        # Published widths (none may be cut).
        assert hp["hidden_channels"] == [48, 96, 192, 384]
        assert hp["attn_window_size"] == [8, 8, 4]
        assert hp["pos_bias_embed_dim"] == 64


def test_workloads_load_by_name(manifest):
    pairs = set()
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4)
        pair = (w["config"], w["traffic"])
        assert pair not in pairs
        pairs.add(pair)
        cell = common.load_cell(manifest, w["name"], 2 ** 31 + 11, 1.0,
                                False)
        assert (common.BENCH / "drivers"
                / f"{cell.traffic['driver']}.py").exists()
        assert hasattr(common.driver(cell), "run")
        assert cell.traffic["limits"]
    fours = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert fours <= max(1, len(manifest["workloads"]) // 4)


def test_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reported = {c: {n for n, m in e2e.items()
                    if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
    layers = set()
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for c in m["workloads"]:
            assert m["moves"] in reported[c]
        assert TEXT.match(m["layer"])
        layers.add(m["layer"])
        readers = common.per_layer_readers(manifest, m["workloads"][0])
        assert callable(readers[m["name"]])
    for c in cells:
        assert any(c in m["workloads"] for m in manifest["per_layer"])


def test_names_and_units(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            assert NAME.match(w[key])
    for c in manifest["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key)


def test_run_budget(manifest):
    """A full check with 24 cells fits its time."""
    t = manifest["run_seconds"]
    assert (2 + 14 * 24) * (t + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_roofline_and_mfu_names(manifest):
    for m in manifest["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"
