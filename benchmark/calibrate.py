#!/usr/bin/env python3
"""The readings an output check's limits are set from, many seeds in one
process (the benchmark's own runs do not run this):

    python3 benchmark/calibrate.py --workload NAME --seconds S \
        [--seeds 1,2,...] [--control-seeds 7,8,9] \
        [--control-precision bf16|tf32] [--fault-seeds 4,5,6] [--out FILE]

For each of ``--seeds``: one run of the cell (set-up, a window of ``S``
seconds, the check) with the program, its compared numbers. For each of
``--control-seeds``: the control's numbers at the cell's size, the plain
reference computed one step below the configuration's precision in the
program's place (``bf16``, the control; ``tf32``, a reading beside it).
For each of ``--fault-seeds`` (training cells): the numbers of each fault
planted in the reference. One JSON line each, on standard output and
appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import run as brun  # noqa: E402


def _ints(text: str):
    return [int(x) for x in text.split(",") if x.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-precision", default="bf16",
                   choices=("bf16", "tf32"))
    p.add_argument("--fault-seeds", default="",
                   help="training cells: the faults' readings, planted in "
                        "the reference")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    brun._environment()
    bench = brun.load_json(os.path.join(brun.ROOT, "BENCHMARK.json"))
    _cell, config, traffic, _limits = brun.cell_files(bench, args.workload)
    driver = brun._load_module(os.path.join(HERE, "drivers",
                                            traffic["driver"] + ".py"),
                               "bench_driver_" + traffic["driver"])

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in _ints(args.seeds):
        t0 = time.perf_counter()
        out = brun.run_cell(bench, args.workload, seed, args.seconds, False,
                            device=args.device)
        emit({"workload": args.workload, "kind": "program", "seed": seed,
              "correct": out["correct"], "metrics": out["metrics"],
              "checks": {k: v["value"] for k, v in out["checks"].items()},
              "seconds": time.perf_counter() - t0})
    for kind, seeds_ in (("control", args.control_seeds),
                         ("faults", args.fault_seeds)):
        for seed in _ints(seeds_):
            t0 = time.perf_counter()
            work = tempfile.mkdtemp(prefix="wfl_bench_" + kind)
            try:
                kw = ({"precision": args.control_precision}
                      if kind == "control" else {})
                readings = getattr(driver, kind)(config, traffic, seed,
                                                 args.device, work, **kw)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            emit({"workload": args.workload, "kind": kind, "seed": seed,
                  "precision": kw.get("precision"), "checks": readings,
                  "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
