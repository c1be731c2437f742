"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 3 [--control | --fault NAME] [--set KEY=JSON ...] \
        [--out FILE]

Without ``--control``: full runs of the cell (set-up, a window of
``--seconds``, the check) for each seed in one process; each prints the
compared numbers (with the leaves that the widest training gaps came
from), the end-to-end metrics and ``correct`` as one JSON line.  With
``--fault NAME`` the same with a fault of ``faults.py`` planted.  With
``--control``: the reference computed with float8 (e4m3, per-tensor
scales) operands put in the program's place, compared with the fp32
reference as a run compares the program: the upper readings.
``--set in_flight=4`` overrides a key of the cell's traffic file (the
sweep that a serving cell's ``in_flight`` is chosen from).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import common, faults  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None,
                   help="plant a fault of benchmark/faults.py first")
    p.add_argument("--set", action="append", default=[],
                   help="KEY=JSON: override a key of the traffic file")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    manifest = common.load_manifest(ROOT)
    common.set_cache_dirs()
    chips = next(w["chips"] for w in manifest["workloads"]
                 if w["name"] == args.workload)
    common.require_cuda(chips)
    out = open(args.out, "a") if args.out else None
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            cell = common.load_cell(manifest, args.workload, seed,
                                    args.seconds, False, ROOT)
            for kv in args.set:
                key, value = kv.split("=", 1)
                cell.traffic[key] = json.loads(value)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            drv = common.driver(cell)
            if args.control:
                got = drv.control(cell)
                checks = got if isinstance(got, dict) else {"prob_gap": got}
                line = {"workload": cell.name, "seed": seed, "kind": "control",
                        "checks": checks}
            else:
                o = drv.run(cell)
                line = {"workload": cell.name, "seed": seed,
                        "kind": args.fault or "program", "set": args.set,
                        "correct": o.correct, "detail": o.detail,
                        "checks": {k: v for k, (v, _) in o.checks.items()},
                        "metrics": o.metrics,
                        "setup_s": o.setup_end - t0,
                        "memory_peak_bytes": o.memory_peak_bytes}
            line["seconds"] = time.perf_counter() - t0
            text = json.dumps(line)
            print(text, flush=True)
            if out is not None:
                out.write(text + "\n")
                out.flush()
            common.free_memory()
    finally:
        if undo is not None:
            undo()
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
