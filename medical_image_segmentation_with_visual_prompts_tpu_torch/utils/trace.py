"""The port's tracer: named spans over the work of each served volume and
each training step, and counters.  Off by default.

    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \\
        import trace
    trace.enable()
    ...                        # serve volumes or step a trainer
    snap = trace.collect()     # {"spans": [...], "counters": {...}}
    trace.disable()

Off, :func:`span` and :func:`unit` check one module flag and return the
shared no-op :data:`OFF`, and :func:`count` returns: nothing is recorded
or allocated, no CUDA call is made and no ``record_function`` entered.

On, a span records its name, its id, its parent's id (the innermost span
open in its thread, or the span handed to it), its unit's id, and the
host clock (``time.perf_counter_ns``) at entry and exit.  Inside a unit
on a CUDA device it also records a CUDA event at entry and at exit on
the device's current stream.  Under an active profiler a span also
enters ``torch.profiler.record_function(name)``: it is a user
annotation, on the profiler's own clock, over the ops and kernels it
launched, and a gap of the device inside it is the span's.

:func:`unit` opens a root span with a new unit id: one per served volume
(``serve.volume``, ``infer.predict_device``), one per training step
(``train.step``, the trainers' ``train_step``) and one per kernel build
(``kernels.build``).  Every span opened in it carries its id; a span in
another thread joins it through the handle that ``with unit(...) as
handle`` gave (``span(name, parent=handle)``), as the serving writer's
download does.  A span opened outside every unit is not recorded (it is
:data:`OFF`), nor is a count: the helpers that a training step shares with validation
(``DeviceCtx.stage``, the forwards, the multi-view losses) and the
runner that validation's sliding window shares with serving open their
spans in both, and only a step's or a served volume's are recorded.

:func:`collect` waits for the devices the spans' events are on and
returns, and clears, what was recorded: ``spans``, one dict each (``name``,
``id``, ``parent``, ``unit``, ``start_ns``, ``end_ns``, ``host_ms``,
``device_ms`` -- the milliseconds between the entry and exit events, None
without events), and the ``counters`` of :func:`count`.  Spans are kept
in memory only; the trainers' ``profile_dir`` trace, which
``train/common.py::StepProfiler`` records with the tracer on, is where
they are written out.  Under a data group each rank traces itself.
``tools/torch_trace_pass.py`` reduces the spans of a benchmark cell.

Spans: ``serve.volume`` (unit), ``serve.crop`` (the crop's copy, crop
coverage), ``serve.pad``, ``serve.upload``, ``serve.preprocess``,
``serve.blend_weights``, per window chunk ``serve.gather``,
``serve.forward`` and ``serve.stitch``, then ``serve.divide``,
``serve.argmax`` and, in ``infer.serve_volumes``'s writer,
``serve.download``; ``train.step`` (unit), ``train.stage``,
``train.views``, ``train.forward`` (each forward), ``train.loss``,
``train.backward``, ``train.optimizer``; ``kernels.build`` (unit).
Counters: ``serve.windows`` and ``serve.forwards`` per volume,
``kernels.builds`` (0 when the built library was there).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List

import torch

_on = False
_lock = threading.Lock()
_local = threading.local()
_span_ids = itertools.count(1)
_unit_ids = itertools.count(1)
_done: List["_Span"] = []
_counters: Dict[str, int] = {}


class _Off:
    """The span of a tracer that is off: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "unit", "device", "start", "end",
                 "e0", "e1", "_rf", "_handed", "_root")

    def __init__(self, name: str, parent, device, root: bool):
        self.name = name
        self._handed = parent
        self.device = None if device is None else torch.device(device)
        self._root = root
        self.e0 = self.e1 = None

    def __enter__(self):
        stack = _stack()
        par = self._handed or (stack[-1] if stack else None)
        self.id = next(_span_ids)
        self.parent = None if par is None else par.id
        if self._root:
            self.unit = next(_unit_ids)
        else:
            self.unit, self.device = par.unit, par.device
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        if self.device is not None and self.device.type == "cuda":
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record(torch.cuda.current_stream(self.device))
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.e0 is not None:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record(torch.cuda.current_stream(self.device))
        self.end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        with _lock:
            _done.append(self)
        return False

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "unit": self.unit, "start_ns": self.start,
                "end_ns": self.end, "host_ms": (self.end - self.start) * 1e-6,
                "device_ms": None if self.e0 is None
                else float(self.e0.elapsed_time(self.e1))}


def span(name: str, parent=None):
    """A span named ``name`` (a context manager).  ``parent``: the handle
    of a span open in another thread, whose unit this one joins; else
    the innermost span open in this thread.  :data:`OFF` outside every
    unit."""
    if not _on:
        return OFF
    if not isinstance(parent, _Span):
        stack = _stack()
        if not stack:
            return OFF
        parent = None
    return _Span(name, parent, None, False)


def unit(name: str, device=None):
    """A root span that starts a new unit (one served volume, one training
    step); ``device``: where its work runs (CUDA: its spans record
    events).  ``with unit(...) as handle``: the handle for other
    threads' spans."""
    if not _on:
        return OFF
    return _Span(name, None, device, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; nothing outside every unit."""
    if not _on or not _stack():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording, from nothing."""
    global _on
    with _lock:
        _done.clear()
        _counters.clear()
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`collect`."""
    global _on
    _on = False


def collect() -> dict:
    """Wait for the spans' devices; return and clear the spans and the
    counters recorded (see the module's docstring)."""
    with _lock:
        done = sorted(_done, key=lambda s: s.start)
        _done.clear()
        counters = dict(_counters)
        _counters.clear()
    for device in {s.device for s in done if s.e0 is not None}:
        torch.cuda.synchronize(device)
    return {"spans": [s.record() for s in done], "counters": counters}
