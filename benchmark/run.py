"""Benchmark of the PyTorch/CUDA port on one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root, the cell's configuration
and traffic files, and runs the traffic's driver
(``benchmark/drivers/<driver>.py``).  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` runs the traced units
(``common.traced``: unprofiled with CUDA events, under CUDA-only
profiling, and a few with the host's ops profiled to label the device's
idle gaps) and prints the per-layer metrics, each read by its file in
``benchmark/metrics/``.  The last line of standard output is one
JSON object; the numbers compared with the reference, each with its
limit, are the last lines of standard error and the result's last key.
Without a CUDA card, or with fewer than the cell asks for, it exits 2
and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import arith, common  # noqa: E402


def result(cell: common.Cell, manifest: dict, outcome: common.Outcome,
           setup_s: float) -> dict:
    device = common.device_info(outcome.memory_peak_bytes, cell.chips)
    metrics = {}
    if cell.trace:
        ctx = dict(outcome.ctx)
        kind = device["kind"]
        ctx["peak_tflops"] = arith.PEAK_TFLOPS.get(kind)
        ctx["peak_tbytes"] = arith.PEAK_TBYTES.get(kind)
        readers = common.per_layer_readers(manifest, cell.name)
        for m in manifest["per_layer"]:
            if m["name"] not in readers:
                continue
            value = readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device["busy_s"] = float(ctx["busy_s"])
        device["window_s"] = float(ctx["window_s"])
    else:
        units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
        for name, value in outcome.metrics.items():
            metrics[name] = {"value": float(value), "unit": units[name]}
        metrics["setup_s"] = {"value": float(setup_s), "unit": "s"}
    out = {"correct": outcome.correct, "attempted": int(outcome.attempted),
           "failed": int(outcome.failed), "metrics": metrics,
           "device": device}
    if cell.trace:
        out["breakdown"] = {"device_ops": outcome.ctx["device_ops"],
                            "idle_gaps": outcome.ctx["idle_gaps"]}
    out["checks"] = common.checks_json(outcome.checks)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest = common.load_manifest(ROOT)
    cell = common.load_cell(manifest, args.workload, args.seed, args.seconds,
                            bool(args.trace), ROOT)
    common.set_cache_dirs()
    common.require_cuda(cell.chips)
    drv = common.driver(cell)
    outcome = drv.run(cell)
    setup_s = outcome.setup_end - T_START
    found = common.forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}, which the measured program may "
              "not load", file=sys.stderr)
        return 3
    line = result(cell, manifest, outcome, setup_s)
    common.print_checks(outcome.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
