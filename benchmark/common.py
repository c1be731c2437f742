"""Shared machinery of the benchmark: the manifest, a cell's inputs, the
device checks, the timing window, the profiler trace's reduction and the
result line.

Nothing here imports the measured program; the drivers do.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax",
             "medical_image_segmentation_with_visual_prompts_tpu")
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
DEVICE = "cuda"


@dataclasses.dataclass
class Cell:
    """One run of one cell: its manifest entry, configuration, traffic
    and run arguments."""

    name: str
    chips: int
    config: dict            # the configuration file (``hparams`` inside)
    traffic: dict           # the traffic file
    seed: int
    seconds: float
    trace: bool
    end_to_end: tuple = ()  # names of the cell's end-to-end metrics

    def sub_seed(self, tag: str) -> int:
        """A 32-bit seed for one use, drawn from ``--seed`` and a tag."""
        words = [int(b) for b in tag.encode()]
        seq = np.random.SeedSequence([int(self.seed) & (2 ** 64 - 1), *words])
        return int(seq.generate_state(1)[0])

    def hparams(self) -> dict:
        return dict(self.config["hparams"])


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(manifest: dict, workload: str, seed: int, seconds: float,
              trace: bool, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its configuration and traffic
    files (``benchmark/workloads/<traffic>.json``)."""
    wl = next((w for w in manifest["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{wl['traffic']}.json")
                         .read_text())
    e2e = tuple(m["name"] for m in manifest["end_to_end"]
                if workload in m.get("workloads", [workload]))
    return Cell(workload, int(wl["chips"]), config, traffic, int(seed),
                float(seconds), bool(trace), end_to_end=e2e)


def load_module(path: Path, name: str):
    """Import a benchmark file by its path (metric files have dots in
    their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py",
                       f"benchmark_driver_{cell.traffic['driver']}")


def per_layer_readers(manifest: dict, workload: str) -> Dict[str, Callable]:
    """``name -> read(ctx)`` of every per-layer metric of the cell."""
    out = {}
    for m in manifest["per_layer"]:
        if workload in m.get("workloads", [workload]):
            mod = load_module(BENCH / "metrics" / f"{m['name']}.py",
                              "benchmark_metric_" + m["name"].replace(".", "_"))
            out[m["name"]] = mod.read
    return out


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that a run may not load,
    compared whole (the program's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def require_cuda(chips: int) -> None:
    """Exit without a result where the card or the cards are missing."""
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {torch.cuda.device_count()} CUDA devices, the "
              f"cell needs {chips}", file=sys.stderr)
        sys.exit(2)


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def free_memory() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def memory_peak() -> int:
    import torch
    return int(torch.cuda.max_memory_allocated())


class Sample:
    """A sample of ``k`` of the requests that completed, drawn from a
    seed: each request number gets a seeded priority and the ``k`` lowest
    are kept, so the sample depends on which requests completed and not
    on when."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.seed = int(seed)
        self.kept: list = []            # (priority, request, item)

    def offer(self, request: int, item) -> None:
        u = float(np.random.default_rng([self.seed, int(request)]).random())
        self.kept.append((u, request, item))
        self.kept.sort(key=lambda e: e[0])
        del self.kept[self.k:]

    @property
    def items(self) -> list:
        return [(r, item) for _, r, item in sorted(self.kept,
                                                   key=lambda e: e[1])]


# ----------------------------------------------------------------- tracing
def device_activity():
    from torch.profiler import ProfilerActivity
    return ProfilerActivity.CUDA


class Trace:
    """``torch.profiler`` over some units of work.  ``device``: CUDA
    activity only, for the device's work (kernels, copies, fills), busy
    time and kernel times; ``labels``: with the host's ops too, which
    slows the host, only to name what the host was doing in each idle
    gap of the device."""

    def __init__(self, kind: str = "device"):
        self.kind = kind
        self.prof = None
        self.t0 = self.t1 = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = {device_activity()}
        if self.kind == "labels":
            acts.add(ProfilerActivity.CPU)
        sync()
        self.prof = profile(activities=acts, record_shapes=False)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def reduce(self) -> dict:
        """Device intervals, kernels by name, busy seconds, and the idle
        gaps labelled by the innermost host op running over each."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for evt in self.prof.events():
            tr = evt.time_range
            if evt.device_type == cuda:
                if getattr(evt, "is_user_annotation", False):
                    continue
                kind = getattr(evt, "activity_type", None)
                kind = None if kind is None else str(kind).lower()
                if kind is None or kind in DEVICE_WORK:
                    dev.append((evt.name, tr.start, tr.end, kind))
            else:
                host.append((evt.name, tr.start, tr.end))
        dev.sort(key=lambda e: e[1])
        by_name: Dict[str, float] = {}
        kernels = []
        busy, cur_s, cur_e = 0.0, None, None
        gaps = []
        for name, s, e, kind in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
            if kind in (None, "kernel"):
                kernels.append((name, s, e))
            if cur_s is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        idle: Dict[str, float] = {}
        host.sort(key=lambda h: h[1])
        starts = np.array([h[1] for h in host]) if host else np.zeros(0)
        for g0, g1 in gaps:
            # The covering op that started last is the innermost one.
            mid = 0.5 * (g0 + g1)
            label = "host idle"
            last = int(np.searchsorted(starts, mid, "right")) - 1
            for i in range(last, max(last - 5000, -1), -1):
                name, s, e = host[i]
                if e >= mid:
                    label = name
                    break
            idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"kernels": kernels, "busy_s": busy * 1e-6,
                "window_s": self.window_s, "device_ops": top(by_name),
                "idle_gaps": top(idle), "has_device": bool(dev)}


def traced(units: Callable[[int, Optional["ForwardEvents"]], object],
           n: int, n_labels: int, events: "ForwardEvents") -> dict:
    """The traced run's three passes over the same work, back to back.

    1. ``n`` units unprofiled, with CUDA events at the model's hooks:
       the window that the rates of the per-layer metrics divide by, and
       the per-unit event times (the profiler does not slow this pass).
    2. ``n`` units under CUDA-only profiling: the device's busy time, its
       kernels and their times.
    3. ``n_labels`` units with the host's ops profiled too: only the
       labels of the idle gaps (that pass's gaps are the profiler's).

    ``units(k, events)`` runs ``k`` units and returns what the driver
    reads of them (``events`` is None in passes 2 and 3)."""
    sync()
    t0 = time.perf_counter()
    timed = units(n, events)
    sync()
    plain_s = time.perf_counter() - t0
    events.remove()
    with Trace("device") as tr:
        units(n, None)
    ctx = tr.reduce()
    with Trace("labels") as lt:
        units(n_labels, None)
    ctx["idle_gaps"] = lt.reduce()["idle_gaps"]
    ctx.update(units=n, plain_window_s=plain_s, timed=timed)
    return ctx


def kernel_seconds(ctx: dict, names) -> Optional[float]:
    """Summed time of the kernels whose name holds one of ``names``;
    None where none ran."""
    secs = [(e - s) * 1e-6 for n, s, e in ctx["kernels"]
            if any(k in n for k in names)]
    return sum(secs) if secs else None


class ForwardEvents:
    """CUDA events at the model's forward entry and exit (and, where an
    optimizer is given, at its step's entry), for the per-layer metrics
    of the traced run."""

    def __init__(self, model, optimizer=None):
        import torch
        self.torch = torch
        self.marks: list = []       # ("fwd0" | "fwd1" | "opt", event)
        self.handles = [model.register_forward_pre_hook(self._mark("fwd0")),
                        model.register_forward_hook(self._mark("fwd1"))]
        if optimizer is not None:
            self.handles.append(optimizer.register_step_pre_hook(
                self._mark("opt")))

    def _mark(self, tag):
        def hook(*_args, **_kw):
            evt = self.torch.cuda.Event(enable_timing=True)
            evt.record()
            self.marks.append((tag, evt))
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def mark(self, tag: str) -> None:
        """A host-side unit boundary (no event)."""
        self.marks.append((tag, None))

    def units(self, tag: str) -> List[list]:
        """The marks cut into units, each starting at a ``tag`` mark."""
        units = []
        for t, evt in self.marks:
            if t == tag:
                units.append([])
            elif units:
                units[-1].append((t, evt))
        return units

    @staticmethod
    def forward_ms(unit) -> float:
        total, start = 0.0, None
        for tag, evt in unit:
            if tag == "fwd0":
                start = evt
            elif tag == "fwd1" and start is not None:
                total += start.elapsed_time(evt)
                start = None
        return total

    @staticmethod
    def backward_ms(unit) -> Optional[float]:
        last_fwd = None
        for tag, evt in unit:
            if tag == "fwd1":
                last_fwd = evt
            elif tag == "opt" and last_fwd is not None:
                return last_fwd.elapsed_time(evt)
        return None


# ------------------------------------------------------------------ result
@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end readings, the compared
    numbers with their limits, the counts, the peak memory, when set-up
    ended, and (traced) the context the per-layer readers read."""

    metrics: Dict[str, float]
    checks: Dict[str, tuple]        # name -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    setup_end: float                # host clock when set-up ended
    ctx: Optional[dict] = None
    detail: Optional[dict] = None   # what the widest gaps came from

    @property
    def correct(self) -> bool:
        return all(np.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


def device_info(peak: int, chips: int = 1) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(chips), "memory_peak_bytes": int(peak)}


def checks_json(checks: Dict[str, tuple]) -> dict:
    return {k: {"value": float(v), "limit": float(lim)}
            for k, (v, lim) in checks.items()}


def print_checks(checks: Dict[str, tuple]) -> None:
    for k, (v, lim) in checks.items():
        print(f"check {k} {float(v)!r} limit {float(lim)!r}", file=sys.stderr)
