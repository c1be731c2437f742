"""The port's tracer (``utils/trace.py``) over one benchmark cell.

Runs the cell's traced run (``benchmark/run.py --trace 1``, its three
passes and its result line as they are) and then, on the same units,
three passes with the tracer on:

a. the labels pass again (host ops profiled): an idle gap of the device
   now takes the name of the program span the host was in;
b. ``n`` units (the cell's ``trace_units``) unprofiled: the spans and
   counters that :func:`reduce_spans` reduces, and the pass's seconds
   over the first pass's;
c. ``PAIRS`` pairs of ``n`` units unprofiled, tracer off and on, which
   of the two runs first alternating: the tracing cost per pair,
   ``on / off - 1``, reported as its median and quartiles.

    python3 tools/torch_trace_pass.py --workload serve_ct320x24_s075 \\
        --seed 3141592653 --out chiprun_out/trace/serve_ct320x24_s075.json

Needs the card, as the harness does.  ``--out`` receives one JSON
object: ``metrics`` (:func:`unit_metrics`), ``spans`` and ``counters``
per unit (:func:`reduce_spans`), ``cost`` and the labels pass's largest
idle gaps with the tracer off and on (``idle_gaps_off``,
``idle_gaps_on``, seconds over the pass by label).  Nothing of the
harness is changed: ``benchmark.common.traced`` is wrapped in this
process only.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PAIRS = 10
SECONDS = "10"      # the harness's measured window, which nothing here reads
SERVE_DEVICE = ("serve.preprocess", "serve.gather", "serve.stitch",
                "serve.divide", "serve.argmax")


def units_of(spans, root):
    """The spans of each unit whose root span is named ``root``."""
    units = {}
    for s in spans:
        units.setdefault(s["unit"], []).append(s)
    return [m for m in units.values()
            if any(s["name"] == root and s["parent"] is None for s in m)]


def _total(members, names, clock):
    """Sum of ``clock`` (``host_ms`` or ``device_ms``) over the unit's
    spans named in ``names``; 0.0 where there are none, None where
    they have no such reading."""
    vals = [s[clock] for s in members if s["name"] in names]
    if any(v is None for v in vals):
        return None
    return float(sum(vals))


def _mean(vals):
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def unit_metrics(spans):
    """Each a mean over the units that have its spans:

    * ``upload_wait_ms.serve``: host ms in ``serve.upload``;
    * ``dispatch_ms.serve``: host ms in ``serve.volume`` minus
      ``serve.upload``;
    * ``stitch_ms.serve``: device ms between the entry and exit events of
      ``serve.preprocess``, ``serve.gather``, ``serve.stitch``,
      ``serve.divide`` and ``serve.argmax``, summed;
    * ``dispatch_ms.train``: host ms in ``train.step`` minus
      ``train.stage``;
    * ``stage_ms.train``: host ms in ``train.stage``;
    * ``optimizer_ms.train``: device ms of ``train.optimizer``.
    """
    out = {}
    vols = units_of(spans, "serve.volume")
    if vols:
        up = [_total(m, {"serve.upload"}, "host_ms") for m in vols]
        whole = [_total(m, {"serve.volume"}, "host_ms") for m in vols]
        out["upload_wait_ms.serve"] = _mean(up)
        out["dispatch_ms.serve"] = _mean([w - u for w, u in zip(whole, up)])
        out["stitch_ms.serve"] = _mean(
            [_total(m, SERVE_DEVICE, "device_ms") for m in vols])
    steps = units_of(spans, "train.step")
    if steps:
        stage = [_total(m, {"train.stage"}, "host_ms") for m in steps]
        whole = [_total(m, {"train.step"}, "host_ms") for m in steps]
        out["dispatch_ms.train"] = _mean(
            [w - s for w, s in zip(whole, stage)])
        out["stage_ms.train"] = _mean(stage)
        out["optimizer_ms.train"] = _mean(
            [_total(m, {"train.optimizer"}, "device_ms") for m in steps])
    return out


def reduce_spans(spans, counters, root):
    """Per span name the mean per unit (units rooted at ``root``) of its
    host ms, its device ms and how many there were; the counters per
    unit; and the number of units."""
    units = units_of(spans, root)
    names = sorted({s["name"] for m in units for s in m})
    per_name = {n: {
        "host_ms": _mean([_total(m, {n}, "host_ms") for m in units]),
        "device_ms": _mean([_total(m, {n}, "device_ms") for m in units]),
        "per_unit": _mean([sum(s["name"] == n for s in m) for m in units])}
        for n in names}
    n = len(units)
    return {"units": n, "spans": per_name,
            "counters": {k: v / n for k, v in counters.items()} if n else {}}


def pair_costs(offs, ons):
    """``on / off - 1`` per pair, with their median and quartiles
    (``statistics.quantiles(n=4)``)."""
    costs = [b / a - 1 for a, b in zip(offs, ons)]
    q = statistics.quantiles(costs, n=4)
    return {"pairs": costs, "median": statistics.median(costs),
            "q1": q[0], "q3": q[2]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import common
    from benchmark import run as bench_run
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import trace

    found = {}
    harness_traced = common.traced

    def timed(units, n, on):
        if on:
            trace.enable()
        common.sync()
        t0 = time.perf_counter()
        units(n, None)
        common.sync()
        seconds = time.perf_counter() - t0
        snap = trace.collect()
        trace.disable()
        return seconds, snap

    def traced(units, n, n_labels, events):
        ctx = harness_traced(units, n, n_labels, events)
        trace.enable()
        with common.Trace("labels") as labels:
            units(n_labels, None)
        trace.collect()
        trace.disable()
        seconds, snap = timed(units, n, True)
        offs, ons = [], []
        for i in range(PAIRS):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                (ons if on else offs).append(timed(units, n, on)[0])
        found.update(
            idle_gaps_off=ctx["idle_gaps"],
            idle_gaps_on=labels.reduce()["idle_gaps"],
            pass1_s=ctx["plain_window_s"], pass_b_s=seconds,
            snap=snap, cost=dict(pair_costs(offs, ons), offs=offs, ons=ons,
                                 pass_b_over_pass1=seconds
                                 / ctx["plain_window_s"] - 1))
        return ctx

    common.traced = traced
    rc = bench_run.main(["--workload", args.workload, "--seed", args.seed,
                         "--seconds", SECONDS, "--trace", "1"])
    if rc or not found:
        return rc or 1
    snap = found.pop("snap")
    root = "serve.volume" if args.workload.startswith("serve") \
        else "train.step"
    out = dict(workload=args.workload, seed=args.seed,
               metrics=unit_metrics(snap["spans"]),
               **reduce_spans(snap["spans"], snap["counters"], root),
               **found)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("metrics", "units", "counters")}
                     | {"cost": {k: out["cost"][k]
                                 for k in ("median", "q1", "q3",
                                           "pass_b_over_pass1")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
