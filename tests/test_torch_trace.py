"""PyTorch port: the tracer (``utils/trace.py``) and its spans in the
serving runner and the trainers, on the CPU at the tiny size.

* Off: ``span`` and ``unit`` are the one shared no-op, with no
  ``record_function``, no CUDA call and no allocation, and nothing is
  collected after a served volume and a training step.
* On: one ``serve.volume`` unit per volume with every ``serve.*`` span
  under it, the counters equal to the runner's plan, at pad and at crop
  coverage, and ``tools/torch_trace_pass.py``'s reduction of them; the
  ``train.*`` spans of a segmentation and a multi-view step under their
  ``train.step``, and none of validation's; the span names as user
  annotations of a CPU profiler, nested as the spans are; a span in a
  second thread in the unit it was handed, and none outside a unit; the
  kernel build's unit and counter.
"""

import threading
import tracemalloc
from argparse import Namespace

import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch import (
    config, infer)
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    kernels
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    multi_view, segmentation
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import (
    init_weights, trace)
from test_torch_swin_unetr import tiny_conf
from tools import torch_trace_pass

SHAPE = (30, 18, 9)         # 12 windows at stride 0.5: 2 chunks of 10


class _Null:
    def info(self, *a, **k):
        pass


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()


@pytest.fixture(scope="module")
def model():
    conf = tiny_conf()
    return conf, init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                              torch.Generator().manual_seed(0))


@pytest.fixture
def runner(model):
    """A new runner (empty caches) and its roi."""
    conf, net = model
    return infer.make_runner(conf, net, chunk=10, stride=0.5), tuple(
        conf["roi_size"])


def _runner(model, coverage):
    conf, net = model
    return infer.make_runner(conf, net, chunk=10, stride=0.5,
                             coverage=coverage), tuple(conf["roi_size"])


def _volumes(n):
    rng = np.random.default_rng(4)
    return [rng.normal(0, 400, size=(*SHAPE, 1)).astype(np.int16)
            for _ in range(n)]


@pytest.fixture(scope="module")
def seg_trainer():
    tr = segmentation.SegmentationTrainer(
        Namespace(**tiny_conf(seed=0)), SwinUnetR, None, None, _Null(),
        device="cpu")
    tr.prepare_fit()
    tr.model.train()
    return tr


def _seg_batch():
    rng = np.random.default_rng(5)
    return {"image": rng.normal(size=(2, 16, 16, 8, 1)).astype(np.float32),
            "mask": rng.integers(0, 3, (2, 16, 16, 8, 1)).astype(
                np.float32)}


def _by_unit(spans):
    units = {}
    for s in spans:
        units.setdefault(s["unit"], []).append(s)
    return units


def _check_tree(spans, root_name):
    """One root per unit, named ``root_name``; every other span of the
    unit reaches it through its parents."""
    by_id = {s["id"]: s for s in spans}
    for u, members in _by_unit(spans).items():
        assert u is not None
        roots = [s for s in members if s["parent"] is None]
        assert [r["name"] for r in roots] == [root_name]
        for s in members:
            while s["parent"] is not None:
                s = by_id[s["parent"]]
                assert s["unit"] == u
            assert s is roots[0]
        for s in members:
            assert s["end_ns"] >= s["start_ns"]
            assert s["device_ms"] is None        # no events on the CPU


def test_off_is_one_no_op_without_calls_or_allocation(monkeypatch, runner,
                                                      seg_trainer):
    def refused(*a, **k):
        raise AssertionError("called with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    assert trace.span("serve.pad") is trace.OFF
    assert trace.unit("train.step", "cuda") is trace.OFF
    tracemalloc.start()
    try:
        for _ in range(1000):
            with trace.unit("serve.volume", "cuda"):
                with trace.span("serve.pad"):
                    trace.count("serve.windows", 3)
        allocated = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, trace.__file__)]).statistics("lineno")
    finally:
        tracemalloc.stop()
    assert allocated == []
    run, roi = runner
    infer.predict_device(run, roi, _volumes(1)[0])
    seg_trainer.train_step(_seg_batch())
    assert trace.collect() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("coverage", ["pad", "crop"])
def test_served_volumes_are_units_and_count_the_plan(model, coverage):
    run, roi = _runner(model, coverage)
    trace.enable()
    for vol in _volumes(2):
        infer.predict_device(run, roi, vol)
    snap = trace.collect()
    spans = snap["spans"]
    _check_tree(spans, "serve.volume")
    units = _by_unit(spans)
    assert len(units) == 2
    dims = SHAPE if coverage == "pad" else tuple(
        s.stop - s.start for s in infer.window_starts(SHAPE, roi, 0.5)[0])
    _, starts, valid = run.plan(dims)
    n = int(valid.sum())
    chunks = -(-n // run.resolve_chunk(n))
    assert chunks == {"pad": 2, "crop": 1}[coverage]
    for members in units.values():
        names = [s["name"] for s in members]
        assert sorted(set(names)) == sorted([
            "serve.volume", "serve.pad", "serve.upload", "serve.preprocess",
            "serve.blend_weights", "serve.gather", "serve.forward",
            "serve.stitch", "serve.divide", "serve.argmax"]
            + ["serve.crop"] * (coverage == "crop"))
        for name in ("serve.gather", "serve.forward", "serve.stitch"):
            assert names.count(name) == chunks
    assert snap["counters"] == {"serve.windows": 2 * n,
                                "serve.forwards": 2 * chunks}
    # The reduction of tools/torch_trace_pass.py: per unit, host ms only
    # on the CPU.
    red = torch_trace_pass.reduce_spans(spans, snap["counters"],
                                        "serve.volume")
    assert red["units"] == 2
    assert red["counters"] == {"serve.windows": n, "serve.forwards": chunks}
    assert red["spans"]["serve.forward"]["per_unit"] == chunks
    assert red["spans"]["serve.forward"]["device_ms"] is None
    got = torch_trace_pass.unit_metrics(spans)
    up = [s["host_ms"] for s in spans if s["name"] == "serve.upload"]
    vol = [s["host_ms"] for s in spans if s["name"] == "serve.volume"]
    assert got["upload_wait_ms.serve"] == pytest.approx(sum(up) / 2)
    assert got["dispatch_ms.serve"] == pytest.approx(
        (sum(vol) - sum(up)) / 2)
    assert got["stitch_ms.serve"] is None


def test_validation_outside_a_unit_records_nothing(runner, seg_trainer):
    """The runner and the helpers a step shares with validation open
    their spans outside every unit there: none is recorded."""
    run, _ = runner
    trace.enable()
    with torch.inference_mode():
        run(_volumes(1)[0])
    seg_trainer.eval_step(_seg_batch())
    with trace.span("serve.download"):
        trace.count("serve.windows")
    assert trace.collect() == {"spans": [], "counters": {}}


def test_training_steps_are_units(seg_trainer):
    mv = multi_view.MultiViewTrainer(
        Namespace(**tiny_conf(training_mode=config.PHASE1_MODE, seed=0)),
        SwinUnetR, None, None, _Null(), device="cpu")
    mv.prepare_fit()
    mv.model.train()
    image = np.random.default_rng(6).normal(
        size=(2, 16, 16, 8, 1)).astype(np.float32)
    trace.enable()
    seg_trainer.train_step(_seg_batch())
    mv.eval_step({"image": image})
    mv.train_step({"image": image})
    spans = trace.collect()["spans"]
    _check_tree(spans, "train.step")
    seg, views = _by_unit(spans).values()
    assert [s["name"] for s in seg] == [
        "train.step", "train.stage", "train.forward", "train.loss",
        "train.backward", "train.optimizer"]
    assert [s["name"] for s in views] == [
        "train.step", "train.stage", "train.views", "train.forward",
        "train.forward", "train.loss", "train.backward", "train.optimizer"]


def test_spans_are_profiler_annotations(runner):
    run, roi = runner
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        infer.predict_device(run, roi, _volumes(1)[0])
    spans = trace.collect()["spans"]
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.time_range)
    for s in spans:
        assert s["name"] in events
    volume, = events["serve.volume"]
    for name in ("serve.upload", "serve.forward", "serve.stitch",
                 "serve.argmax"):
        for r in events[name]:
            assert volume.start <= r.start and r.end <= volume.end
    assert any(r.start <= f.start and f.end <= r.end
               for r in events["serve.forward"]
               for f in events.get("aten::conv3d", []))


def test_span_in_another_thread_keeps_the_unit_it_was_handed():
    trace.enable()
    with trace.unit("serve.volume") as handle:
        pass
    seen = []

    def writer():
        with trace.span("serve.download", parent=handle) as s:
            seen.append(s)
        with trace.span("serve.download"):
            pass

    t = threading.Thread(target=writer)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen
    root, handed = trace.collect()["spans"]      # not the one unhanded
    assert handed["unit"] == root["unit"] and handed["parent"] == root["id"]


def test_kernel_build_unit_and_counter(tmp_path, monkeypatch):
    lib = tmp_path / "libmivp_kernels_cached.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(kernels, "library_path", lambda: lib)
    trace.enable()
    assert kernels.build() == lib
    snap = trace.collect()
    assert [s["name"] for s in snap["spans"]] == ["kernels.build"]
    assert snap["counters"] == {"kernels.builds": 0}
